"""Learning-rate schedule of ``tpugan/train/optim.py``. The optimizer itself
is ``torch.optim.Adam``: bias-corrected moments with eps 1e-8 outside the
sqrt, which is what ``adam_torch`` reproduces in optax."""

from __future__ import annotations


def linear_decay_lambda(n_epochs: int, decay_start_epoch: int, offset: int = 0):
    """The LambdaLR factor of cyclegan/utils.py:36-44, ``1 - max(0, epoch +
    offset - decay_start) / (n_epochs - decay_start)``, floored at 0 as
    ``linear_decay_schedule`` floors it: past ``n_epochs`` the reference's
    factor turns negative and every update into gradient ascent. Step the
    LambdaLR once per epoch."""

    def factor(epoch: int) -> float:
        frac = max(0, epoch + offset - decay_start_epoch) / (n_epochs - decay_start_epoch)
        return max(0.0, 1.0 - frac)

    return factor
