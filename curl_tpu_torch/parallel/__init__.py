"""Party runtimes (counterpart of ``curl_tpu/parallel``): ``run_parties``,
``compile_parties``, the private forward captured as a CUDA graph, and
``compile_parties_cached``, its offline/online split."""

from .runner import (  # noqa: F401
    CachedFill,
    CachedOnline,
    CompiledParties,
    Public,
    compile_parties,
    compile_parties_cached,
    mpc_context,
    run_parties,
    run_parties_spmd,
    shard_map_parties,
)
