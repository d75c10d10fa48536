from .gpt import GPT, GPT2, load_numpy_state_dict  # noqa: F401
