"""Plain PyTorch references of the benchmark's configurations: the
reference repository's ``models.py`` and training step, written anew with
``torch.nn`` alone. They import nothing of ``tpugan_torch``."""
