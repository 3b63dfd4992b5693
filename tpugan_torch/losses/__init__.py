from tpugan_torch.losses.adversarial import l1, mse

__all__ = ["l1", "mse"]
