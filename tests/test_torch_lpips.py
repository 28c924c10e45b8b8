"""LPIPS in riggs_tpu_torch against riggs_tpu's, from one set of seeded
state dicts in the real on-disk layout (scripts/make_lpips_ckpt.py's:
torchvision ``features.<i>.weight/bias`` and the lpips package's
``lin<i>.model.1.weight``), on seeded 64 x 64 images.

Tolerances: the distance atol 1e-6, rtol 1e-5 (both packages run the same
f32 convolutions on the CPU, in different orders); the importer's result
bitwise equal under any order of the state dicts' keys; evaluate_image's
psnr, ssim and ms_ssim 1e-5 of their scale, its LPIPS as the distance.

ROADMAP C3: riggs_tpu's AlexNet pools 2x2 with stride 2, torchvision's
(the published metric's backbone) 3x3 with stride 2. The port computes what
riggs_tpu computes; a test shows the two pools give different distances on
the same weights.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from riggs_tpu.eval import metrics as JMet
from riggs_tpu_torch.eval import metrics as TMet
from scripts.make_lpips_ckpt import ALEX_CONVS, ALEX_HEAD_CH, VGG_CONVS, VGG_HEAD_CH

from tests.test_torch_stage1_loop import one_torch_thread  # noqa: F401 (autouse)

ATOL, RTOL = 1e-6, 1e-5


def seeded_state_dicts(net, seed=0):
    """make_lpips_ckpt.write_ckpts' weights, biases made nonzero, without
    the classifier (its 2-D keys are what the importer must skip: two small
    ones stand in)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for idx, cout, cin, k in ALEX_CONVS if net == "alex" else VGG_CONVS:
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.normal(size=(cout, cin, k, k)) / np.sqrt(k * k * cin)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(rng.normal(scale=0.05, size=cout).astype(np.float32))
    sd["classifier.1.weight"], sd["classifier.1.bias"] = torch.zeros(4, 9), torch.zeros(4)
    lsd = {f"lin{i}.model.1.weight": torch.from_numpy(np.abs(rng.normal(size=(1, c, 1, 1))).astype(np.float32) * 0.01)
           for i, c in enumerate(ALEX_HEAD_CH if net == "alex" else VGG_HEAD_CH)}
    return sd, lsd


def images(seed, n=None, size=64):
    rng = np.random.default_rng(seed)
    shape = (size, size, 3) if n is None else (n, size, size, 3)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1).astype(np.float32)
    return a, b


@pytest.fixture(scope="module")
def models():
    out = {}
    for net in ("alex", "vgg"):
        sd, lsd = seeded_state_dicts(net)
        out[net] = (JMet.LpipsModel.from_torch_state_dicts(sd, lsd, net=net),
                    TMet.LpipsModel.from_torch_state_dicts(sd, lsd, net=net, device="cpu"))
    return out


@pytest.mark.parametrize("net", ["alex", "vgg"])
@pytest.mark.parametrize("batch", [None, 2])
def test_lpips_matches(models, net, batch):
    jm, tm = models[net]
    a, b = images(3, batch)
    ref = float(jm(jnp.asarray(a), jnp.asarray(b)))
    port = tm(torch.from_numpy(a), torch.from_numpy(b))
    assert port.dim() == 0 and port.dtype == torch.float32
    print(f"{net} batch {batch}: reference {ref:.9f} port {float(port):.9f}")
    np.testing.assert_allclose(float(port), ref, atol=ATOL, rtol=RTOL)
    assert ref > 1e-4
    assert float(tm(torch.from_numpy(a), torch.from_numpy(a))) == 0.0


def test_importer_ignores_key_order_and_reads_files(models, tmp_path):
    sd, lsd = seeded_state_dicts("vgg")
    a, b = (torch.from_numpy(x) for x in images(5))
    base = float(models["vgg"][1](a, b))
    rng = np.random.default_rng(1)
    for perm in (lambda d: dict(reversed(list(d.items()))),
                 lambda d: dict(sorted(d.items())),
                 lambda d: {k: d[k] for k in rng.permutation(list(d))}):
        m = TMet.LpipsModel.from_torch_state_dicts(perm(sd), perm(lsd), net="vgg", device="cpu")
        assert float(m(a, b)) == base
    # lpips package heads may be saved without the ".model.1" infix; a plain Sequential without "features."
    plain = {k.removeprefix("features."): v for k, v in sd.items()}
    heads = {k.replace(".model.1", ""): v for k, v in lsd.items()}
    assert float(TMet.LpipsModel.from_torch_state_dicts(plain, heads, net="vgg", device="cpu")(a, b)) == base
    torch.save(sd, tmp_path / "vgg_backbone.pth")
    torch.save(lsd, tmp_path / "vgg.pth")
    m = TMet.LpipsModel.from_torch_file(tmp_path / "vgg_backbone.pth", tmp_path / "vgg.pth", net="vgg", device="cpu")
    assert float(m(a, b)) == base
    with pytest.raises(ValueError, match="conv layers"):
        TMet.LpipsModel.from_torch_state_dicts({}, lsd, net="vgg", device="cpu")
    with pytest.raises(ValueError, match="linear heads"):
        TMet.LpipsModel.from_torch_state_dicts(sd, dict(list(lsd.items())[:4]), net="vgg", device="cpu")


def test_random_init_shapes():
    for net, n_convs in (("alex", 5), ("vgg", 13)):
        m = TMet.LpipsModel.random_init(torch.Generator().manual_seed(0), net=net, device="cpu")
        assert len(m.convs) == n_convs and len(m.lins) == 5
        a, b = (torch.from_numpy(x) for x in images(2))
        d = m(a, b)
        assert bool(torch.isfinite(d)) and float(d) > 0


def test_evaluate_image_with_lpips(models):
    a, b = images(7)
    for net in ("alex", "vgg"):
        jm, tm = models[net]
        ref = JMet.evaluate_image(jnp.asarray(a), jnp.asarray(b), jm)
        port = TMet.evaluate_image(torch.from_numpy(a), torch.from_numpy(b), tm)
        assert list(port) == list(ref) == ["psnr", "ssim", "ms_ssim", f"lpips_{net}"]
        for k in ("psnr", "ssim", "ms_ssim"):
            assert abs(port[k] - ref[k]) <= 1e-5 * max(1.0, abs(ref[k])), (k, port[k], ref[k])
        np.testing.assert_allclose(port[f"lpips_{net}"], ref[f"lpips_{net}"], atol=ATOL, rtol=RTOL)


def _alex_lpips(sd, lsd, a, b, pool):
    """LPIPS with the AlexNet trunk pooled by ``pool`` (kernel, stride)."""
    shift = torch.tensor(TMet._IMAGENET_SHIFT).view(1, 3, 1, 1)
    scale = torch.tensor(TMet._IMAGENET_SCALE).view(1, 3, 1, 1)

    def feats(x):
        x = (2.0 * x.permute(0, 3, 1, 2) - 1.0 - shift) / scale
        out = []
        for j, (idx, _, _, k) in enumerate(ALEX_CONVS):
            stride, pad = (4, 2) if j == 0 else (1, k // 2)
            x = torch.relu(F.conv2d(x, sd[f"features.{idx}.weight"], sd[f"features.{idx}.bias"], stride, pad))
            out.append(x)
            if j < 2:
                x = F.max_pool2d(x, *pool)
        return out

    total = 0.0
    for i, (fa, fb) in enumerate(zip(feats(a[None]), feats(b[None]))):
        fa = fa / torch.clamp(fa.norm(dim=1, keepdim=True), min=1e-10)
        fb = fb / torch.clamp(fb.norm(dim=1, keepdim=True), min=1e-10)
        total = total + F.conv2d((fa - fb) ** 2, lsd[f"lin{i}.model.1.weight"]).mean()
    return float(total)


def test_c3_alexnet_pool_differs_from_torchvision(models):
    """ROADMAP C3: the same seeded weights through riggs_tpu's 2x2 pool (the
    port's) and through torchvision's 3x3 stride-2 pool give different
    distances."""
    sd, lsd = seeded_state_dicts("alex")
    a, b = (torch.from_numpy(x) for x in images(11))
    port = float(models["alex"][1](a, b))
    two = _alex_lpips(sd, lsd, a, b, (2, 2))
    three = _alex_lpips(sd, lsd, a, b, (3, 2))
    print(f"C3: port {port:.6f}, 2x2 pool {two:.6f}, torchvision's 3x3 pool {three:.6f}")
    np.testing.assert_allclose(two, port, rtol=1e-5)
    assert abs(three - two) > 0.01 * two
