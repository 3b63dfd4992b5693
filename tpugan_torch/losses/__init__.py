from tpugan_torch.losses.adversarial import (
    bce,
    cross_entropy_logits,
    cross_entropy_on_softmax,
    l1,
    mse,
)

__all__ = ["bce", "cross_entropy_logits", "cross_entropy_on_softmax", "l1", "mse"]
