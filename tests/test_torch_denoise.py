"""Port parity for the image benchmark: data/images.py,
data/dictionary.py, data/fixtures.py, run_denoise.py and utils/plots.py.

The same numpy images, dictionaries, noise and parameters go through the
JAX package's functions (its Pallas kernels in interpret mode, as
tests/test_denoise.py runs them) and the port's on the CPU (the kernels'
plain versions). Tolerances, each with its reason:
  * the DCT dictionary, the image grid, patches, the median DC and the
    corruption masks are equal bit for bit;
  * the synthetic image's texture strip within one float32 ulp
    (torch.sin and XLA's sin round differently at some points);
  * overlap-average reconstruction within 1e-6; forwards and restored
    images within rtol 1e-5 / atol 1e-5 (the summation order of the
    products);
  * the loss within rtol 1e-5, its gradients within 2e-5 of each leaf's
    largest value (tests/test_pallas_bwd.py's tolerance);
  * learn_dictionary by its LASSO objective within 5% of the JAX
    package's: the MOD solve's Gram matrix is rank-deficient here (fewer
    used atoms than 256), so the two libraries' roundings move the
    learned atoms themselves far apart while the fit stays as good.
The random streams differ by design (torch.Generator against
jax.random): the end-to-end gains are held to the JAX tests' bounds
(> 3 dB denoise, > 5 dB inpaint at the tiny training budget)."""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from dladmm_tpu import run_denoise as jrd
from dladmm_tpu.data import dictionary as jdict
from dladmm_tpu.data import fixtures as jfix
from dladmm_tpu.data import images as jimg
from dladmm_tpu.models.unroll import DLADMMParams as JParams
from dladmm_tpu.models.unroll import dladmm_forward as j_forward
from dladmm_tpu.models.unroll import init_dladmm_params as j_init
from dladmm_tpu.train import loop as jloop
from dladmm_tpu_torch import run_denoise as trd
from dladmm_tpu_torch.data import dictionary as tdict
from dladmm_tpu_torch.data import fixtures as tfix
from dladmm_tpu_torch.data import images as timg
from dladmm_tpu_torch.metrics.core import psnr
from dladmm_tpu_torch.train import loop as tloop
from dladmm_tpu_torch.utils.torch_compat import params_from_numpy


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _impulse(img, density, seed):
    """img with a fraction ``density`` of pixels set to 0 or 1 (numpy draws)."""
    rng = np.random.default_rng(seed)
    hit = rng.random(img.shape) < density
    return np.where(hit, (rng.random(img.shape) < 0.5).astype(np.float32), img).astype(np.float32)


def test_dct_dictionary_equal():
    D = tdict.dct_dictionary()
    assert D.shape == (64, 256) and D.dtype == torch.float32
    np.testing.assert_array_equal(D.numpy(), np.asarray(jdict.dct_dictionary()))
    np.testing.assert_allclose(np.linalg.norm(D.numpy(), axis=0), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(tdict.dct_dictionary(4, 6).numpy(), np.asarray(jdict.dct_dictionary(4, 6)))


@pytest.mark.parametrize("size", [32, 64, 128])
def test_synthetic_image_equal(size):
    """The grid is jnp.linspace's bit for bit (torch.linspace is not), so
    every shape's edge falls on the same pixels; only the texture strip's
    sin may differ, by one float32 ulp."""
    t, j = timg.synthetic_image(size).numpy(), np.asarray(jimg.synthetic_image(jax.random.PRNGKey(0), size))
    grid = np.asarray(jnp.linspace(0, 1, size))
    np.testing.assert_array_equal(timg._grid(size), grid)
    assert (torch.linspace(0, 1, 128).numpy() != np.asarray(jnp.linspace(0, 1, 128))).any()
    strip = grid[:, None].repeat(size, 1) > 0.8
    np.testing.assert_array_equal(t[~strip], j[~strip])
    np.testing.assert_allclose(t[strip], j[strip], rtol=0, atol=2.0**-24)
    assert t.dtype == np.float32 and 0.0 <= t.min() and t.max() <= 1.0


@pytest.mark.parametrize("stride", [4, 8, 5])
def test_patches_reconstruction_and_dc_match_jax(stride):
    """extract_patches, reconstruct_from_patches and patch_dc on an
    impulse-corrupted image (stride 5 leaves uncovered pixels). The DC is
    the median of 64 values: the mean of the two middle ones, as
    jnp.median takes it (torch.median returns the lower)."""
    img = _impulse(np.asarray(jimg.synthetic_image(jax.random.PRNGKey(0), 64)), 0.2, stride)
    tp = timg.extract_patches(torch.from_numpy(img), 8, stride)
    jp = jimg.extract_patches(jnp.asarray(img), patch=8, stride=stride)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    rec = timg.reconstruct_from_patches(tp * 1.5, 64, 8, stride)
    jrec = jimg.reconstruct_from_patches(jp * 1.5, 64, patch=8, stride=stride)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), rtol=0, atol=1e-6)
    dc = timg.patch_dc(tp)
    assert dc.shape == (tp.shape[0], 1)
    np.testing.assert_array_equal(dc.numpy(), np.asarray(jimg.patch_dc(jp)))
    even = torch.arange(64.0)[None]
    assert float(timg.patch_dc(even)) == float(jnp.median(jnp.arange(64.0))) == 31.5
    assert float(torch.median(even)) == 31.0  # why the port does not use torch.median
    assert float(timg.patch_dc(torch.arange(63.0)[None])) == 31.0
    robust = torch.full((3, 64), 0.4)
    robust[:, :6] = 1.0  # 6 of 64 impulses
    np.testing.assert_allclose(timg.patch_dc(robust).numpy(), 0.4, atol=1e-6)
    if stride in (4, 8):  # a round trip where the patches cover the image
        np.testing.assert_allclose(timg.reconstruct_from_patches(tp, 64, 8, stride).numpy(), img, atol=1e-6)


def test_corruption_densities():
    g = torch.Generator().manual_seed(0)
    img = torch.full((128, 128), 0.5)
    noisy = timg.salt_pepper(g, img, 0.2)
    assert 0.15 < float((noisy != 0.5).float().mean()) < 0.25
    assert set(np.unique(noisy.numpy())) <= {0.0, 0.5, 1.0}
    assert 0.4 < float((noisy == 1.0).float().sum() / (noisy != 0.5).float().sum()) < 0.6
    dropped, mask = timg.dropout_mask(g, img, 0.3)
    assert 0.25 < 1.0 - float(mask.mean()) < 0.35
    np.testing.assert_array_equal(dropped.numpy(), (img * mask).numpy())
    assert set(np.unique(mask.numpy())) <= {0.0, 1.0}
    again = timg.salt_pepper(torch.Generator().manual_seed(0), img, 0.2)
    assert torch.equal(again, noisy)  # the stream is the generator's


def test_learn_dictionary_matches_jax_objective():
    """FISTA coding equal to the JAX package's within rtol 1e-5; the
    learned dictionary keeps unit-norm atoms, lowers the LASSO objective
    below 0.9x the DCT's (the JAX test's check), and fits within 5% of
    the JAX package's learned dictionary."""
    img = jimg.synthetic_image(jax.random.PRNGKey(0), 64)
    P = jimg.extract_patches(img, 8, 4)
    P = np.asarray(P - jnp.mean(P, axis=1, keepdims=True))
    tP, D0 = torch.from_numpy(P), tdict.dct_dictionary()
    X = tdict._fista_code(D0, tP, 0.05, 25)
    Xj = np.asarray(jdict._fista_code(jdict.dct_dictionary(), jnp.asarray(P), 0.05, 25))
    np.testing.assert_allclose(X.numpy(), Xj, rtol=1e-5, atol=1e-5 * np.abs(Xj).max())
    D = tdict.learn_dictionary(tP, D0, n_atoms=256, outer=4, fista_iters=25)
    Dj = jdict.learn_dictionary(jnp.asarray(P), jdict.dct_dictionary(), n_atoms=256, outer=4, fista_iters=25)
    assert D.shape == D0.shape
    np.testing.assert_allclose(np.linalg.norm(D.numpy(), axis=0), 1.0, rtol=1e-3)

    def objective(Dk):
        Xk = tdict._fista_code(Dk, tP, 0.05, 25)
        r = tP - Xk @ Dk.T
        return float(0.5 * torch.sum(r * r) + 0.05 * torch.sum(torch.abs(Xk)))

    ours, theirs = objective(D), objective(torch.from_numpy(np.asarray(Dj)))
    assert ours < 0.9 * objective(D0)
    assert abs(ours - theirs) <= 0.05 * theirs, (ours, theirs)
    with pytest.raises(ValueError, match="n_atoms"):
        tdict.learn_dictionary(tP, D0, n_atoms=128, outer=1)


def test_mat_fixtures(tmp_path):
    """.mat dictionaries and images written with scipy: the auto-picked,
    transposed, keyed and unnormalized cases and the key errors, against
    the JAX package's loaders."""
    rng = np.random.default_rng(0)
    D = rng.normal(size=(64, 256))
    path = str(tmp_path / "dict.mat")
    sio.savemat(path, {"D": D})
    A = tfix.load_mat_dictionary(path)
    np.testing.assert_array_equal(A.numpy(), np.asarray(jfix.load_mat_dictionary(path)))
    np.testing.assert_allclose(np.linalg.norm(A.numpy(), axis=0), 1.0, rtol=1e-5)
    tall = str(tmp_path / "dict_t.mat")
    sio.savemat(tall, {"W": rng.normal(size=(256, 64))})
    with pytest.warns(UserWarning, match="auto-transposed"):
        At = tfix.load_mat_dictionary(tall, key="W")
    assert At.shape == (64, 256)
    np.testing.assert_array_equal(At.numpy(), np.asarray(jfix.load_mat_dictionary(tall, key="W")))
    assert tfix.load_mat_dictionary(tall, key="W", transpose=False).shape == (256, 64)
    multi = str(tmp_path / "multi.mat")
    sio.savemat(multi, {"D1": np.eye(4), "D2": np.eye(4)})
    with pytest.raises(ValueError, match="pass key="):
        tfix.load_mat_dictionary(multi)
    with pytest.raises(KeyError, match="available"):
        tfix.load_mat_dictionary(multi, key="nope")
    np.testing.assert_allclose(tfix.load_mat_dictionary(multi, key="D2", normalize=False).numpy(), np.eye(4))
    img8 = (rng.random((32, 32)) * 255).astype(np.uint8)
    p8 = str(tmp_path / "img8.mat")
    sio.savemat(p8, {"img": img8})
    np.testing.assert_array_equal(tfix.load_mat_image(p8).numpy(), np.asarray(jfix.load_mat_image(p8)))
    np.testing.assert_allclose(tfix.load_mat_image(p8).numpy(), img8 / 255.0, atol=1e-6)
    imgf = rng.random((16, 16))
    pf = str(tmp_path / "imgf.mat")
    sio.savemat(pf, {"img": imgf})
    np.testing.assert_allclose(tfix.load_mat_image(pf).numpy(), imgf, atol=1e-6)


def _params(A, K, seed=0, perturb=0.02):
    p0 = j_init(jnp.asarray(A), K=K, beta=1.0)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(v) + perturb * rng.normal(size=v.shape).astype(np.float32) for v in p0]
    leaves[-1] = np.abs(leaves[-1])
    return JParams(*map(jnp.asarray, leaves)), params_from_numpy(*leaves)


@pytest.mark.parametrize("mode", ["denoise", "inpaint"])
def test_denoise_image_matches_jax(mode):
    """denoise_image on the same params and noisy image (the JAX package's
    through its Pallas whole-unroll kernel in interpret mode)."""
    A = np.asarray(jdict.dct_dictionary())
    jp, tp = _params(A, K=4)
    clean = np.asarray(jimg.synthetic_image(jax.random.PRNGKey(0), 64))
    mask = None
    if mode == "inpaint":
        mask = (np.random.default_rng(1).random(clean.shape) >= 0.3).astype(np.float32)
        noisy = clean * mask
    else:
        noisy = _impulse(clean, 0.1, 2)
    got = trd.denoise_image(tp, torch.from_numpy(A), torch.from_numpy(noisy),
                            mask=None if mask is None else torch.from_numpy(mask))
    want = jrd.denoise_image(jp, jnp.asarray(A), jnp.asarray(noisy), mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if mask is not None:
        obs = mask > 0
        np.testing.assert_allclose(got.numpy()[obs], noisy[obs], atol=1e-6)


def _batch(A, K, seed=3):
    """One training batch of the pipeline from numpy impulses, and the
    JAX-side and port-side params."""
    clean = np.asarray(jimg.synthetic_image(jax.random.PRNGKey(0), 32))
    noisy = _impulse(clean, 0.1, seed)
    pn = np.asarray(jimg.extract_patches(jnp.asarray(noisy), 8, 4))
    pc = np.asarray(jimg.extract_patches(jnp.asarray(clean), 8, 4))
    dc = np.asarray(jimg.patch_dc(jnp.asarray(pn)))
    return (pn - dc, pc - dc, pn - pc), _params(A, K, seed=seed, perturb=0.05)


@pytest.mark.parametrize("layer_loss", [None, "uniform"])
def test_denoise_loss_and_grads_match_jax(layer_loss):
    """denoise_loss and its gradients against jax.value_and_grad of the
    same composition from the JAX package's public functions (its scan,
    weighted_trajectory_mse and _layer_weights)."""
    A = np.asarray(jdict.dct_dictionary())
    K = 4
    (b, tr, tn), (jp, tp) = _batch(A, K)
    jA = jnp.asarray(A)
    jlw = None if layer_loss is None else jloop._layer_weights(layer_loss, K, jnp.float32)

    def jloss(p):
        if jlw is not None:
            _, (tx, te, _) = j_forward(p, jA, jnp.asarray(b), capture_trajectory=True)
            return jloop.weighted_trajectory_mse(jnp.matmul(tx, jA.T), te, jnp.asarray(tr), jnp.asarray(tn), jlw)
        x, e, _ = j_forward(p, jA, jnp.asarray(b))
        return jnp.mean((x @ jA.T - jnp.asarray(tr)) ** 2) + jnp.mean((e - jnp.asarray(tn)) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jp)
    tlw = tloop._layer_weights(layer_loss, K)
    tl, tg = trd.denoise_grad(tp, torch.from_numpy(A), *map(torch.from_numpy, (b, tr, tn)), tlw)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    tl2 = trd.denoise_loss(tp, torch.from_numpy(A), *map(torch.from_numpy, (b, tr, tn)), tlw)
    assert float(tl2) == float(tl)
    for name, g, w in zip(JParams._fields, tg, jg):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5 * (np.abs(w).max() + 1e-12), err_msg=name)


def test_jax_saved_denoiser_served_by_the_port(tmp_path):
    """A denoiser saved by the JAX package loads and serves in the port as
    in the JAX package; the port's save loads back bit for bit, and in
    the JAX package."""
    A = np.asarray(jdict.dct_dictionary())
    jp, _ = _params(A, K=4, seed=9)
    path = tmp_path / "jax_net.npz"
    jrd.save_denoiser(path, jp, jnp.asarray(A))
    tp, tA = trd.load_denoiser(path)
    assert all(np.array_equal(_np(a), np.asarray(b)) for a, b in zip(tp, jp))
    noisy = _impulse(np.asarray(jimg.synthetic_image(jax.random.PRNGKey(0), 64)), 0.1, 4)
    got = trd.denoise_image(tp, tA, torch.from_numpy(noisy))
    want = jrd.denoise_image(jp, jnp.asarray(A), jnp.asarray(noisy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    ours = tmp_path / "port_net.npz"
    trd.save_denoiser(ours, tp, tA)
    tp2, tA2 = trd.load_denoiser(ours)
    assert all(torch.equal(a, b) for a, b in zip(tp, tp2)) and torch.equal(tA, tA2)
    jp2, jA2 = jrd.load_denoiser(ours)
    assert all(np.array_equal(np.asarray(a), _np(b)) for a, b in zip(jp2, tp))


@pytest.mark.parametrize("mode,density,floor_db", [("denoise", 0.1, 3.0), ("inpaint", 0.3, 5.0)])
def test_quick_scale_gain(mode, density, floor_db):
    """A tiny training budget (K = 6, 30 steps, one 64 x 64 image) gives a
    clear PSNR gain (the JAX tests' bounds); inpainting passes the
    observed pixels through exactly."""
    A = tdict.dct_dictionary()
    clean = timg.synthetic_image(64)
    params = trd.train_denoiser(A, [clean], K=6, steps=30, density=density, log_every=0, mode=mode, seed=1)
    noisy, mask = trd._corrupt(torch.Generator().manual_seed(2), clean, mode, density)
    recon = trd.denoise_image(params, A, noisy, mask=mask)
    gain = float(psnr(recon, clean)) - float(psnr(noisy, clean))
    assert gain > floor_db, gain
    if mask is not None:
        obs = mask > 0
        np.testing.assert_allclose(recon[obs].numpy(), noisy[obs].numpy(), atol=1e-6)


def _jax_parser():
    """The JAX CLI's parser, caught at its parse_args."""

    class Caught(Exception):
        pass

    def catch(self, *a, **k):
        raise Caught(self)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        jrd.main([])
    except Caught as c:
        return c.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError("the JAX CLI did not parse its arguments")


def test_parser_has_every_jax_flag_with_its_default():
    def flags(ap):
        return {tuple(a.option_strings): (a.dest, a.default, tuple(a.choices or ()))
                for a in ap._actions if a.option_strings and a.dest != "help"}

    assert flags(trd._parser()) == flags(_jax_parser())


@pytest.mark.parametrize("argv", [
    ["--load", "x.npz", "--dict=learned"],
    ["--load", "x.npz", "--dict-mat", "d.mat"],
    ["--load", "x.npz", "--save", "y.npz"],
    ["--dict-mat", "d.mat", "--dict=learned"],
    ["--mask", "m.npy"],
    ["--load", "x.npz", "--mode=inpaint", "--input-image", "i.npy"],
    ["--mode=blur"],
])
def test_cli_validation_errors(argv, monkeypatch):
    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    with pytest.raises(SystemExit):
        trd.main(argv)


def test_cli_quick_save_load_input_image(tmp_path, capsys, monkeypatch):
    """``run_denoise --quick`` on the CPU: the JAX CLI's JSON keys, a
    positive gain; --save, then --load --input-image restores a saved
    corrupted image equal to the in-process denoise_image; --dict-mat
    takes a .mat dictionary."""
    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    net = tmp_path / "net.npz"
    assert trd.main(["--quick", "--steps=1", "--save", str(net)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"mode", "dict", "results", "mean_psnr_gain_db"} <= set(summary)
    assert summary["route"] == "whole-unroll-plain-cpu" and summary["device"] == "cpu"
    assert len(summary["results"]) == 3 and summary["mean_psnr_gain_db"] > 0
    params, A = trd.load_denoiser(net)
    assert params.K == 8 and tuple(A.shape) == (64, 256)
    noisy, _ = trd._corrupt(torch.Generator().manual_seed(5), timg.synthetic_image(64), "denoise", 0.1)
    inp, out = tmp_path / "noisy.npy", tmp_path / "recon.npy"
    np.save(inp, noisy.numpy())
    assert trd.main(["--load", str(net), "--input-image", str(inp), "--output-image", str(out)]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["shape"] == [64, 64]
    np.testing.assert_array_equal(np.load(out), trd.denoise_image(params, A, noisy).numpy())
    mat = tmp_path / "dct.mat"
    sio.savemat(mat, {"D": tdict.dct_dictionary().double().numpy()})
    assert trd.main(["--quick", "--dict-mat", str(mat)]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["mean_psnr_gain_db"] > 3.0
    with pytest.raises(SystemExit, match="2-D"):
        np.save(inp, np.zeros((2, 2, 2), np.float32))
        trd.main(["--load", str(net), "--input-image", str(inp)])


def test_run_plot_writes_a_png(tmp_path, capsys, monkeypatch):
    """``run --plot`` writes the NMSE-vs-layer figure (utils/plots.py)."""
    pytest.importorskip("matplotlib")
    from dladmm_tpu_torch import run as trun
    from dladmm_tpu_torch.utils.plots import save_nmse_curve_plot

    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    png = tmp_path / "curve.png"
    assert trun.main(["--config=smoke", "--steps=2", "--plot", str(png)]) == 0
    assert f"plot saved: {png}" in capsys.readouterr().out
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    other = tmp_path / "direct.png"
    assert save_nmse_curve_plot(str(other), [-1.0, -2.0], None) == str(other)
    assert other.stat().st_size > 0
