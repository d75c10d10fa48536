from .gpt import GPT, GPT2, GPTNeo, load_hf_state_dict, load_numpy_state_dict  # noqa: F401
from . import generate  # noqa: F401
