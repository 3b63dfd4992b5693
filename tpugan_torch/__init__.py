"""tpugan_torch: the port of tpugan from JAX on a TPU to PyTorch and CUDA on
an NVIDIA H100 (Hopper).

The JAX package ``tpugan`` is the reference each ported part is checked
against. The module tree mirrors it:

- ``tpugan_torch.ops``     hand-written Hopper kernels (``csrc/*.cu``) with
                           their plain PyTorch versions, image ops
- ``tpugan_torch.nn``      layers and networks (NCHW nn.Modules)
- ``tpugan_torch.losses``  loss functions
- ``tpugan_torch.data``    numpy dataset helpers and prefetching loaders
- ``tpugan_torch.train``   optimizers, replay buffer, loop plumbing
- ``tpugan_torch.io``      PNG sample grids, JAX-parameter loading
- ``tpugan_torch.models``  trainers with the JAX package's flags

It imports no JAX. Of ``tpugan`` it imports only ``tpugan.utils.config`` and
``tpugan.native``, which import none either.
"""

__version__ = "0.1.0"
