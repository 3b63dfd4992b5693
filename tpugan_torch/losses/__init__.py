from tpugan_torch.losses.adversarial import bce, l1, mse

__all__ = ["bce", "l1", "mse"]
