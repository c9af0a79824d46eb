"""Models of the port (GPT-2) and state conversion with the JAX package."""

from pytorch_distributed_tpu_torch.models.convert import (  # noqa: F401
    gpt2_flax_from_state_dict,
    gpt2_state_dict_from_flax,
    load_adamw_state_from_optax,
)
from pytorch_distributed_tpu_torch.models.gpt2 import (  # noqa: F401
    GPT2,
    GPT2Config,
    gpt2_125m,
)

__all__ = [
    "GPT2",
    "GPT2Config",
    "gpt2_125m",
    "gpt2_flax_from_state_dict",
    "gpt2_state_dict_from_flax",
    "load_adamw_state_from_optax",
]
