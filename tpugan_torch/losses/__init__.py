from tpugan_torch.losses.adversarial import (
    bce,
    bce_with_logits,
    boundary_seeking,
    cross_entropy_logits,
    cross_entropy_on_softmax,
    l1,
    mse,
    pullaway,
)

__all__ = ["bce", "bce_with_logits", "boundary_seeking", "cross_entropy_logits",
           "cross_entropy_on_softmax", "l1", "mse", "pullaway"]
