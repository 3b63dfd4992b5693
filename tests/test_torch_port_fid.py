"""The port's FID (``tpugan_torch/metrics``) against the JAX package's
(``tpugan/metrics/fid.py``, ``tpugan/metrics/inception.py``), on the CPU.

- The Fréchet code is a copy of the JAX package's numpy float64 code: the
  same features give the same numbers, exactly.
- The InceptionV3 stem and blocks InceptionA to InceptionE at their real
  channel widths, the whole trunk at 299x299 and the feature models (the
  tanh to unit mapping, the grayscale repeat, ImageNet normalization, the
  resize): the JAX modules' parameters, with their BatchNorm running
  statistics drawn away from 0 and 1, carried into the port by
  ``load_jax_params`` (and by name for VGG19), then the same seeded inputs
  through both. Tolerance: float32 on both sides with convolutions summed
  in different orders, 1e-4 relative plus 1e-4 of the output's largest
  magnitude absolute; the resize on images in [0, 1] 1e-6 absolute
  upsampling and 3e-5 antialiased downsampling, whose filter weights each
  side computes in float32 by its own formula.
- An npz of the JAX parameters exported as a torchvision ``state_dict``
  (``export_state_dict``, then ``scripts/convert_inception.py``'s
  ``convert``) loads with ``strict=True`` into the same weights.
- ``compute_fid`` equals the JAX package's on both sides' load of one
  seeded ``vgg19_features.npz``, 1e-3 relative; without a device it takes
  CUDA, and raises where there is none.
- ``eval_fid`` runs on the CPU at a small size and prints the JAX script's
  JSON line.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_critic_rest import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_port_unet_im2im import key_order, ordered

import tpugan.metrics.fid as fid_j
import tpugan.metrics.inception as inc_j
from tpugan.io.torch_interop import export_state_dict
from tpugan_torch.io.interop import load_jax_params
from tpugan_torch.metrics import eval_fid
from tpugan_torch.metrics import fid as fid_t
from tpugan_torch.metrics import inception as inc_t
from tpugan_torch.ops.image import resize_bilinear

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
from convert_inception import convert  # noqa: E402

CPU = torch.device("cpu")
RTOL, ATOL_SHARE = 1e-4, 1e-4


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_SHARE * np.abs(want).max(),
                               err_msg=what)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _jax_variables(module, x, seed):
    """Variables of ``module`` in ``init`` order, drawn in numpy from
    ``seed`` on the shapes of its ``init`` (traced, not compiled): conv
    kernels He-random, N(0, sqrt(2 / fan_out)) as the JAX trunk's init;
    BatchNorm scales U(0.5, 1.5), biases N(0, 0.1), running means N(0, 0.1)
    and variances U(0.5, 1.5), away from the init's 1, 0, 0, 1 so that
    their transfer shows."""
    skeleton = {}

    def init():
        v = module.init(jax.random.PRNGKey(0), x)
        skeleton.update(key_order(v))
        return v

    shapes = jax.eval_shape(init)
    rng = np.random.default_rng(seed)
    draws = {"kernel": lambda s: rng.normal(0, np.sqrt(2.0 / (s[0] * s[1] * s[3])), s),
             "mean": lambda s: rng.normal(0, 0.1, s), "var": lambda s: rng.uniform(0.5, 1.5, s),
             "scale": lambda s: rng.uniform(0.5, 1.5, s), "bias": lambda s: rng.normal(0, 0.1, s)}

    def draw(tree, sk):
        return {k: draw(tree[k], v) if v is not None else
                draws[k](tree[k].shape).astype(np.float32) for k, v in sk.items()}

    return draw(shapes, skeleton)


def _port(module, variables):
    return load_jax_params(module, variables["params"], variables["batch_stats"])


# --- the Fréchet code ------------------------------------------------------------------------


def test_frechet_code_equals_jax():
    rng = np.random.default_rng(0)
    real = rng.normal(size=(64, 16)).astype(np.float32)
    fake = (rng.normal(size=(48, 16)) * 1.3 + 0.2).astype(np.float32)
    for a, b in zip(fid_t.activation_statistics(real), fid_j.activation_statistics(real)):
        np.testing.assert_array_equal(a, b)
    mu1, s1 = fid_t.activation_statistics(real)
    mu2, s2 = fid_t.activation_statistics(fake)
    assert fid_t.frechet_distance(mu1, s1, mu2, s2) == fid_j.frechet_distance(mu1, s1, mu2, s2)
    assert fid_t.fid_from_features(real, fake) == fid_j.fid_from_features(real, fake)
    assert abs(fid_t.fid_from_features(real, real)) < 1e-9


# --- InceptionV3 -----------------------------------------------------------------------------


class _StemJ(inc_j.nn.Module):
    """The JAX trunk's stem: five BasicConv2d and the two max pools."""

    @inc_j.nn.compact
    def __call__(self, x):
        x = inc_j.BasicConv2d(32, (3, 3), stride=2)(x)
        x = inc_j.BasicConv2d(32, (3, 3))(x)
        x = inc_j.BasicConv2d(64, (3, 3), padding=(1, 1))(x)
        x = inc_j._maxpool3s2(x)
        x = inc_j.BasicConv2d(80, (1, 1))(x)
        x = inc_j.BasicConv2d(192, (3, 3))(x)
        return inc_j._maxpool3s2(x)


def _stem_t():
    m = inc_t.InceptionV3Features(generator=torch.Generator().manual_seed(0))
    return torch.nn.Sequential(m.Conv2d_1a_3x3, m.Conv2d_2a_3x3, m.Conv2d_2b_3x3,
                               torch.nn.MaxPool2d(3, 2), m.Conv2d_3b_1x1, m.Conv2d_4a_3x3,
                               torch.nn.MaxPool2d(3, 2))


# name: (JAX block, port block, input (H, C)); the widths and map sizes of
# the trunk's own Mixed_5b, Mixed_6a, Mixed_6b, Mixed_7a, Mixed_7b, Mixed_7c.
BLOCKS = {
    "stem": (_StemJ(), _stem_t, (75, 3)),
    "A": (inc_j.InceptionA(32), lambda: inc_t.InceptionA(192, 32), (35, 192)),
    "B": (inc_j.InceptionB(), lambda: inc_t.InceptionB(288), (35, 288)),
    "C": (inc_j.InceptionC(128), lambda: inc_t.InceptionC(768, 128), (17, 768)),
    "D": (inc_j.InceptionD(), lambda: inc_t.InceptionD(768), (17, 768)),
    "E": (inc_j.InceptionE(), lambda: inc_t.InceptionE(1280), (8, 1280)),
    "E2048": (inc_j.InceptionE(), lambda: inc_t.InceptionE(2048), (8, 2048)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_inception_blocks_match_jax(name):
    """Each block's output on a seeded (2, C, H, H) input (ReLU'd, as the
    blocks' inputs are), with the JAX block's weights."""
    block_j, make_t, (h, c) = BLOCKS[name]
    x = np.maximum(np.random.default_rng(1).normal(size=(2, h, h, c)), 0).astype(np.float32)
    variables = _jax_variables(block_j, jnp.asarray(x[:1]), seed=2)
    want = np.asarray(jax.jit(block_j.apply)(variables, jnp.asarray(x)))
    block_t = _port(make_t(), variables)
    with torch.no_grad():
        got = _nhwc(block_t(_nchw(x)))
    assert got.shape == want.shape
    _close(got, want, name)


@pytest.fixture(scope="module")
def trunk():
    """The JAX trunk's variables (BatchNorm statistics redrawn) and the port's
    trunk holding them."""
    variables = _jax_variables(inc_j.InceptionV3Features(), jnp.zeros((1, 75, 75, 3)), seed=3)
    port = _port(inc_t.InceptionV3Features(generator=torch.Generator().manual_seed(0)),
                 variables)
    return variables, port


def test_inception_trunk_matches_jax_at_299(trunk):
    """The whole trunk on two 299x299 images: (2, 2048) pooled features."""
    variables, port = trunk
    x = np.random.default_rng(4).uniform(-2, 2, (2, 299, 299, 3)).astype(np.float32)
    want = np.asarray(jax.jit(inc_j.InceptionV3Features().apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(_nchw(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    _close(got, want)


def test_inception_feature_model_matches_jax(trunk, tmp_path, monkeypatch):
    """``InceptionFeatureModel`` on grayscale 32x32 batches in [-1, 1] (the
    tanh mapping, the repeat, ImageNet normalization, the 32 to 299 resize,
    ``transform_input`` affine), the JAX model holding the same weights (handed to
    it in place of its init: flax's eager init of the trunk takes most of a
    minute on the CPU)."""
    variables, port = trunk
    monkeypatch.setattr(inc_j.InceptionV3Features, "init", lambda self, *a: variables)
    model_j = fid_j.InceptionFeatureModel(data_dir=str(tmp_path))
    model_t = fid_t.InceptionFeatureModel(data_dir=str(tmp_path), device=CPU)
    model_t.module = port
    x = np.random.default_rng(5).uniform(-1, 1, (3, 32, 32, 1)).astype(np.float32)
    want = model_j([jnp.asarray(x)])
    got = model_t([_nchw(x[:2]), _nchw(x[2:])])
    assert not model_t.pretrained and got.shape == want.shape == (3, 2048)
    _close(got, want)


def test_an_npz_of_the_jax_export_loads_strictly(trunk, tmp_path):
    """The JAX parameters exported to torchvision's keys and converted to
    ``inception_v3.npz`` load into a fresh trunk with ``strict=True``, equal
    to ``load_jax_params``'s; ``feature_model`` then picks InceptionV3."""
    variables, port = trunk
    template = port.state_dict()
    sd = export_state_dict(variables["params"], template, variables["batch_stats"])
    npz = tmp_path / "inception_v3.npz"
    convert(sd, str(npz))
    fresh = inc_t.load_inception_npz(
        inc_t.InceptionV3Features(generator=torch.Generator().manual_seed(9)), str(npz))
    assert list(fresh.state_dict()) == list(template)
    assert list(template)[:2] == ["Conv2d_1a_3x3.conv.weight", "Conv2d_1a_3x3.bn.weight"]
    assert "Mixed_5b.branch1x1.conv.weight" in template
    for k, v in template.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[k], v), k
    model = fid_t.feature_model(data_dir=str(tmp_path), device=CPU)
    assert isinstance(model, fid_t.InceptionFeatureModel) and model.pretrained


@pytest.mark.parametrize("src, atol", [(64, 1e-6), (320, 3e-5)])
def test_resize_to_299_matches_jax(src, atol):
    """``jax.image.resize(..., "bilinear")`` to 299x299: upsampling from 64,
    and antialiased downsampling from 320, whose filter weights each side
    computes in float32 by its own formula (about 1e-5 apart at most)."""
    x = np.random.default_rng(src).uniform(0, 1, (2, src, src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), method="bilinear"))
    got = _nhwc(resize_bilinear(_nchw(x), (299, 299)))
    np.testing.assert_allclose(got, want, atol=atol)


# --- VGG19 -----------------------------------------------------------------------------------


def test_vgg_feature_model_matches_jax(tmp_path, monkeypatch):
    """``VGGFeatureModel`` (features[:18], mean-pooled) on grayscale 64x64
    batches in [-1, 1], the JAX model's parameters (drawn in place of its
    init) loaded by name."""
    from tpugan.nn.vgg import VGG19Features as VGG19Features_j

    variables = _jax_variables(VGG19Features_j(cut=18), jnp.zeros((1, 64, 64, 3)), seed=7)
    monkeypatch.setattr(VGG19Features_j, "init", lambda self, *a: variables)
    model_j = fid_j.VGGFeatureModel(data_dir=str(tmp_path))
    model_t = fid_t.VGGFeatureModel(data_dir=str(tmp_path), device=CPU)
    load_jax_params(model_t.module, jax.tree_util.tree_map(np.asarray, model_j.params))
    x = np.random.default_rng(6).uniform(-1, 1, (3, 64, 64, 1)).astype(np.float32)
    want = model_j([jnp.asarray(x)])
    got = model_t([_nchw(x)])
    assert not model_t.pretrained and got.shape == want.shape == (3, 256)
    _close(got, want)


def test_compute_fid_matches_jax(tmp_path):
    """``compute_fid`` on two streams of grayscale 64x64 batches in [-1, 1],
    both sides loading one ``vgg19_features.npz`` drawn in numpy (seed 8);
    the FID of features that agree within the tolerance above, 1e-3
    relative."""
    probe = fid_t.VGGFeatureModel(data_dir=str(tmp_path), device=CPU).module
    rng = np.random.default_rng(8)
    arrays = {}
    for idx, layer in enumerate(probe):
        if isinstance(layer, torch.nn.Conv2d):
            o, i, kh, kw = layer.weight.shape
            arrays[f"conv{idx}_kernel"] = rng.normal(
                0, np.sqrt(2.0 / (kh * kw * o)), (kh, kw, i, o)).astype(np.float32)
            arrays[f"conv{idx}_bias"] = rng.normal(0, 0.1, (o,)).astype(np.float32)
    np.savez(tmp_path / "vgg19_features.npz", **arrays)
    x = np.random.default_rng(9).uniform(-1, 1, (12, 64, 64, 1)).astype(np.float32)
    real, fake = x[:6], np.clip(x[6:] * 0.5 + 0.2, -1, 1)
    want = fid_j.compute_fid([jnp.asarray(real)], [jnp.asarray(fake)], data_dir=str(tmp_path))
    got = fid_t.compute_fid([_nchw(real[:3]), _nchw(real[3:])], [_nchw(fake)],
                            data_dir=str(tmp_path), device=CPU)
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_fid_defaults_to_the_card(tmp_path, monkeypatch):
    """Without a device the FID entry points take CUDA and raise where there
    is none: they never move work off the card to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fid_t.compute_fid([], [], data_dir=str(tmp_path))
    for make in (fid_t.VGGFeatureModel, fid_t.InceptionFeatureModel, fid_t.feature_model):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(data_dir=str(tmp_path))


def test_the_extractors_seed_their_own_generator(tmp_path):
    """Two He-random extractors are the same network: the generator seeded
    0, not the global stream."""
    a = fid_t.VGGFeatureModel(data_dir=str(tmp_path), device=CPU).module.state_dict()
    torch.manual_seed(123)
    b = fid_t.VGGFeatureModel(data_dir=str(tmp_path), device=CPU).module.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    ia = inc_t.InceptionV3Features(generator=torch.Generator().manual_seed(0)).state_dict()
    ib = fid_t.InceptionFeatureModel(data_dir=str(tmp_path), device=CPU).module.state_dict()
    assert all(torch.equal(ia[k], ib[k]) for k in ia)


# --- eval_fid --------------------------------------------------------------------------------


def test_eval_fid_prints_the_json_line_of_jax(tmp_path, capsys):
    """``eval_fid`` for DCGAN at 64 samples, batch 32, on the CPU: one JSON
    line with the JAX script's keys; a finite, positive FID; a generator
    state_dict given by ``--state`` is the one scored (the same state twice
    gives the same FID)."""
    from tpugan_torch.models import dcgan

    cfg = dcgan.Config(synthetic_data=True)
    G = dcgan.build(cfg, CPU)["generator"]
    torch.save(G.state_dict(), tmp_path / "G.pth")
    argv = ["--model", "dcgan", "--n_samples", "64", "--batch", "32", "--synthetic_data",
            "--data_dir", str(tmp_path), "--extractor", "vgg", "--state", str(tmp_path / "G.pth")]
    rec = eval_fid.main(argv, CPU)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert set(json.loads(line)) == {"model", "fid", "n"}
    assert json.loads(line)["n"] == 64 and rec["extractor"] == "VGGFeatureModel"
    assert np.isfinite(rec["fid"]) and rec["fid"] > 0 and rec["finite"]
    assert eval_fid.main(argv, CPU)["fid"] == rec["fid"]
