"""The denoiser's training step, ``run_denoise.make_denoise_step``, on the
CPU: against the benchmark's plain reference (``benchmark/reference/
denoise.py``: patches by slicing, the median DC, the final layer's
reconstruction loss through ``reference/solver.unroll`` with autograd,
and ``reference/adam.py``, on the frozen dictionary and image of
``benchmark/yardstick/images.py``) on seeded, perturbed weights; its one
final-state backward a step; with its spans; and ``train_denoiser`` and
the CLI, which run the step, bit for bit what they gave before the step
was a function. On the card: the step through the chunked backward
against the same step on the whole batch."""

import contextlib
import hashlib
import io
import json
import os

import pytest
import torch

from benchmark import inputs
from benchmark.reference import denoise as ref_denoise
from benchmark.reference.adam import Adam
from benchmark.reference.optim import B1
from benchmark.yardstick import images as yimg
from dladmm_tpu_torch import run_denoise as trd
from dladmm_tpu_torch.data import dictionary as tdict
from dladmm_tpu_torch.data import images as timg
from dladmm_tpu_torch.models.unroll import DLADMMParams
from dladmm_tpu_torch.ops import cuda_traj
from dladmm_tpu_torch.train import loop
from dladmm_tpu_torch.utils import profiling

K, SIZE, LR, DENSITY = 3, 32, 1e-3, 0.1
ROWS = 2 * 7 * 7  # two 32 x 32 images, 8 x 8 windows at stride 4
INIT = {"w1_noise": 0.1, "w2_noise": 0.05, "theta_log_sd": 0.2, "beta_log_sd": 0.1}


def _setup(seed):
    A = tdict.dct_dictionary()
    imgs = [timg.synthetic_image(SIZE) for _ in range(2)]
    params = inputs.parameters({"m": 64, "n": 256, "K": K, "beta": 1.0, "init": INIT}, A, seed)
    return A, imgs, params


def _program(seed, steps=3):
    """(losses, first gradient as Adam got it, params after ``steps``)."""
    A, imgs, params = _setup(seed)
    optimizer = loop.adam(LR)
    state = loop.make_train_state(DLADMMParams(*(p.clone() for p in params)), optimizer)
    step = trd.make_denoise_step(optimizer, A, imgs, density=DENSITY, patch=8, stride=4)
    losses, first = [], None
    for i in range(steps):
        state, value = step(state, torch.Generator().manual_seed(100 * seed + i))
        losses.append(float(value))
        if i == 0:
            first = [mu / (1 - B1) for mu in state.opt_state[0].mu]  # fresh moments: mu = (1 - b1) g
    return losses, first, state.params


def _reference(seed, steps=3):
    _, _, params = _setup(seed)
    A, imgs = yimg.dct_dictionary(8, 16), [yimg.synthetic_image(SIZE) for _ in range(2)]
    params = [p.clone() for p in params]
    opt = Adam(params, LR)
    losses, first = [], None
    for i in range(steps):
        gen = torch.Generator().manual_seed(100 * seed + i)
        rows = ref_denoise.patch_batch([yimg.salt_pepper(gen, img, DENSITY) for img in imgs], imgs, 8, 4)
        assert rows[0].shape == (ROWS, 64)
        value, grads = ref_denoise.loss_and_grads(params, A, *rows)
        opt.step(params, grads)
        losses.append(float(value))
        if i == 0:
            first = grads
    return losses, first, params


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_step_matches_the_plain_reference(seed):
    """Losses, every leaf's first gradient and the parameters after three
    steps. The program's CPU path (the trajectory's and the backward's
    plain versions) and autograd through the reference's loop sum in
    other orders: the losses agree within 1.3e-6 and each gradient within
    1.7e-6 of its leaf's largest value over seeds 0-4, so 1e-5 of each;
    Adam moves every element by ~0.7 lr a step whatever its gradient's
    size, so the parameters after three steps agree within 2.7e-6
    (0.27% of lr) and are held to 1e-5 (1% of lr), while every leaf
    moved by more than 2 lr."""
    losses, first, after = _program(seed)
    ref_losses, ref_first, ref_after = _reference(seed)
    assert losses == pytest.approx(ref_losses, rel=1e-5)
    for g, r in zip(first, ref_first):
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())
    _, _, start = _setup(seed)
    for p, r, p0 in zip(after, ref_after, start):
        torch.testing.assert_close(p, r, rtol=0, atol=1e-5)
        assert float((p - p0).abs().max()) > 2 * LR


def test_the_step_takes_the_final_state_backward_once_a_step(monkeypatch):
    """The step's loss reaches the backward through ``cuda_traj.
    unroll_bwd``, the entry of rows 4 and 5, once a step; on the CPU with
    no batch slice (bs None: ``unroll_bwd_plain``, whose result does not
    depend on bs), and the state comes out as without the watch. On the
    card bs is ``bwd_chunk_batch``'s, and the chunked route is held
    against the plain version at the patch shape by
    tests/test_torch_cuda.py::test_patch_shape_kernels_match_plain and in
    the step by test_the_step_on_the_card_through_the_chunked_backward
    below."""
    whole = _program(1)
    real, seen = cuda_traj.unroll_bwd, []

    def watched(*args, bs=None, **kw):
        seen.append(bs)
        return real(*args, bs=bs, **kw)

    monkeypatch.setattr(cuda_traj, "unroll_bwd", watched)
    losses, first, after = _program(1)
    assert seen == [None] * 3
    assert losses == whole[0]
    for a, b in zip((*first, *after), (*whole[1], *whole[2])):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [128, 512])
def test_the_step_on_the_card_through_the_chunked_backward(monkeypatch, bs):
    """On the card at the cell's widths (m = 64, n = 256, K = 15) on two
    128 x 128 images (2 x 31^2 = 1 922 patches): three steps with the
    weight gradients in slices of ``bs`` rows (the chunked route, row 5)
    against the same three steps on the whole batch. Only the order of
    the slices' sums differs: the losses agree within 1e-5 and each
    leaf's first gradient within 2e-5 of its largest value (the card
    test of the backward's), and each step launches the chunked route
    once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chunked route is a kernel with no CPU mode")
    from dladmm_tpu_torch.ops import cuda_bwd

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    dev = torch.device("cuda")
    A = tdict.dct_dictionary(device=dev)
    imgs = [timg.synthetic_image(128, device=dev) for _ in range(2)]
    params = inputs.parameters({"m": 64, "n": 256, "K": 15, "beta": 1.0, "init": INIT}, A, 5)
    runs = {}
    for split in (None, bs):
        monkeypatch.setattr(cuda_traj, "bwd_chunk_batch", lambda *a, _s=split: _s)
        optimizer = loop.adam(LR)
        state = loop.make_train_state(DLADMMParams(*(p.clone() for p in params)), optimizer)
        step = trd.make_denoise_step(optimizer, A, imgs)
        before = dict(cuda_bwd.unroll_bwd.launches)
        losses, first = [], None
        for i in range(3):
            state, value = step(state, torch.Generator(device=dev).manual_seed(700 + i))
            losses.append(float(value))
            if i == 0:
                first = [mu / (1 - B1) for mu in state.opt_state[0].mu]
        route = "whole" if split is None else "chunked"
        assert cuda_bwd.unroll_bwd.launches[route] == before[route] + 3
        runs[split] = losses, first
    (whole_losses, whole_first), (losses, first) = runs[None], runs[bs]
    assert losses == pytest.approx(whole_losses, rel=1e-5)
    for g, w in zip(first, whole_first):
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= 2e-5 * float(w.abs().max())


def test_the_step_opens_its_spans_in_order(tmp_path):
    """One step under a profiler session: ``train.step`` holds
    ``train.data`` (the patch batch) and then ``train.optimizer``."""
    A, imgs, params = _setup(0)
    optimizer = loop.adam(LR)
    state = loop.make_train_state(params, optimizer)
    step = trd.make_denoise_step(optimizer, A, imgs)
    with profiling.trace(str(tmp_path / "tr")) as d:
        step(state, torch.Generator().manual_seed(3))
    with open(os.path.join(d, profiling.TRACE_FILE)) as f:
        names = ("train.step", "train.data", "train.optimizer")
        spans = sorted((e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and e.get("name") in names),
                       key=lambda e: e["ts"])
    assert [e["name"] for e in spans] == list(names)
    outer = spans[0]
    assert all(outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] for e in spans[1:])


# train_denoiser at commit ac0957e, before make_denoise_step, at the
# --quick settings (2 images of 64 x 64, K = 8, 60 steps, the training
# child of seed 7) on one CPU thread: the sha256 of each trained leaf's
# bytes; and its CLI line for --quick --seed 7.
BEFORE_LEAVES = {
    "W1": "1d8a2d28f4931af8ce2e1fcae0ae97b38f83062e8f0ecb202902e65aa5fa5a3e",
    "W2": "005f1ff37d3ff36ce41dc4110bb68ca282c4433caca8984ef0d6d27417455a71",
    "theta1": "07bffa0cc46bf53aa0fe2ce8e02832cedccb8629518780709f76fd91d79915ab",
    "theta2": "5a540d31836e0b2ac5e63486c85d44dc431d0ecd97196c0a24671db97dddc3d9",
    "beta": "6155c6ba81a5d0ee815df46f1ca309a46d67d8090d94715c005cc10365c67909",
}
BEFORE_CLI = ('{"mode": "denoise", "dict": "dct", "results": [{"image": 0, "psnr_noisy_db": 15.78, '
              '"psnr_denoised_db": 35.04}, {"image": 1, "psnr_noisy_db": 15.41, "psnr_denoised_db": 33.42}, '
              '{"image": 2, "psnr_noisy_db": 15.16, "psnr_denoised_db": 34.26}], "mean_psnr_gain_db": 18.79, '
              '"route": "whole-unroll-plain-cpu", "device": "cpu"}')


@contextlib.contextmanager
def _one_thread():
    """One CPU thread: the values above were taken so, and a product
    summed over more threads can differ in its last bits."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def test_train_denoiser_and_the_cli_are_bit_for_bit_what_they_were(monkeypatch):
    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    with _one_thread():
        A = tdict.dct_dictionary()
        imgs = [timg.synthetic_image(64) for _ in range(2)]
        params = trd.train_denoiser(A, imgs, K=8, steps=60, seed=trd.child_seeds(7)[0], log_every=0)
        got = {f: hashlib.sha256(v.detach().numpy().tobytes()).hexdigest() for f, v in params._asdict().items()}
        assert got == BEFORE_LEAVES
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert trd.main(["--quick", "--seed", "7"]) == 0
    assert out.getvalue().strip().splitlines()[-1] == BEFORE_CLI
