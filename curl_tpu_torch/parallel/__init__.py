"""Party runtimes (counterpart of ``curl_tpu/parallel``): ``run_parties``
and ``compile_parties``, the private forward captured as a CUDA graph."""

from .runner import (  # noqa: F401
    CompiledParties,
    Public,
    compile_parties,
    compile_parties_cached,
    mpc_context,
    run_parties,
    run_parties_spmd,
    shard_map_parties,
)
