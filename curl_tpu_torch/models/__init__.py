from .gpt import GPT, GPT2, GPTNeo, load_numpy_state_dict  # noqa: F401
