"""Models of the port (GPT-2, ResNet) and state conversion with the JAX
package."""

from pytorch_distributed_tpu_torch.models.convert import (  # noqa: F401
    full_optimizer_state,
    full_state_dict,
    gpt2_flax_from_state_dict,
    gpt2_state_dict_from_flax,
    load_adamw_state_from_optax,
    load_sgd_state_from_optax,
    resnet_flax_from_state_dict,
    resnet_state_dict_from_flax,
)
from pytorch_distributed_tpu_torch.models.gpt2 import (  # noqa: F401
    GPT2,
    GPT2Config,
    gpt2_125m,
)
from pytorch_distributed_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
)

__all__ = [
    "GPT2",
    "GPT2Config",
    "ResNet",
    "full_optimizer_state",
    "full_state_dict",
    "gpt2_125m",
    "gpt2_flax_from_state_dict",
    "gpt2_state_dict_from_flax",
    "load_adamw_state_from_optax",
    "load_sgd_state_from_optax",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "resnet_flax_from_state_dict",
    "resnet_state_dict_from_flax",
]
