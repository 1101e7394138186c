"""Image denoising / inpainting benchmark CLI, the port of
``dladmm_tpu/run_denoise.py``:

    python -m dladmm_tpu_torch.run_denoise [--quick] [--mode {denoise,inpaint}]
                                           [--dict {dct,learned}]

Pipeline (the JAX package's, flags and defaults alike):
  1. Patch dictionary A (64 x 256): the overcomplete 2-D DCT, or learned
     from clean training patches (FISTA + MOD, data/dictionary.py), or a
     .mat fixture (--dict-mat).
  2. Corrupt the images (salt & pepper impulses, or known-mask pixel
     deletion in inpaint mode); extract overlapping 8 x 8 patches;
     subtract the per-patch median DC.
  3. Train the D-LADMM net on the patches: b = corrupted patch residual,
     loss ||A x_K - clean residual||^2 + ||e_K - corruption||^2 (or, with
     --layer-loss, the reconstruction deep-supervised at every layer).
     Steps 2 and 3 are one training step, ``make_denoise_step``.
  4. Reconstruct A x + DC, overlap-average (inpaint mode keeps the
     observed pixels), report PSNR against the corrupted input's.

Runs on CUDA unless ``DLADMM_PLATFORM=cpu``. The images, the corruption
(``torch.Generator``s on the run's device, seeded from --seed: one stream
for training, one for the test images) and the patches stay on the
device. On the card training runs the trajectory kernel and, for the
final-layer loss, the backward kernel (whole batch or batch slices, by
ops/cuda_bwd.bwd_chunk_batch); deep supervision takes the trajectory
kernel with the plain reverse sweep; restoring an image runs the
whole-unroll kernel. The optimizer is plain fp32 Adam (optax.adam in the
JAX package). The random streams are not jax.random's, so PSNRs agree
with the JAX package's in distribution, not digit for digit.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from dladmm_tpu_torch.utils import profiling


def child_seeds(seed: int):
    """(training, test) seeds of the CLI's ``--seed``: its two children."""
    return tuple(int(s.generate_state(1, np.uint64)[0] >> 1) for s in np.random.SeedSequence(seed).spawn(2))


def _corrupt(gen, img, mode, density):
    """Apply the benchmark corruption. Returns (corrupted, mask-or-None);
    mask 1 marks observed pixels (inpaint mode only)."""
    from dladmm_tpu_torch.data.images import dropout_mask, salt_pepper

    if mode == "inpaint":
        return dropout_mask(gen, img, density)
    return salt_pepper(gen, img, density), None


def _make_patch_batch(gen, images, density, patch, stride, mode="denoise"):
    """Corrupt and patchify one epoch of training data on the images'
    device: (b, clean residual, corruption), each (S, patch*patch)."""
    from dladmm_tpu_torch.data.images import extract_patches, patch_dc

    bs, tgt_res, tgt_noise = [], [], []
    for img in images:
        noisy, _ = _corrupt(gen, img, mode, density)
        p_noisy = extract_patches(noisy, patch, stride)
        p_clean = extract_patches(img, patch, stride)
        dc = patch_dc(p_noisy)
        bs.append(p_noisy - dc)
        tgt_res.append(p_clean - dc)
        tgt_noise.append(p_noisy - p_clean)
    return torch.cat(bs), torch.cat(tgt_res), torch.cat(tgt_noise)


def denoise_loss(params, A, b, tgt_res, tgt_noise, layer_weights=None):
    """The denoiser's training loss: the final layer's reconstruction
    x_K A^T against the clean residual plus e_K against the corruption
    (mean squares), or with ``layer_weights`` (K,) the weighted per-layer
    sum of the same (train/loop.weighted_trajectory_mse on the
    reconstructions). The forward is the port's policy at this shape
    (models/api.resolve_forward: with a gradient, the trajectory kernel
    and the backward kernel on the card), or the trajectory kernel with
    the plain reverse sweep for deep supervision."""
    if layer_weights is not None:
        from dladmm_tpu_torch.ops.cuda_traj import make_unrolled_trajectory
        from dladmm_tpu_torch.train.loop import weighted_trajectory_mse

        tx, te, _ = make_unrolled_trajectory()(params, A, b)  # (K, S, .) stacks
        recon = torch.matmul(tx, A.T)
        return weighted_trajectory_mse(recon, te, tgt_res, tgt_noise, layer_weights)
    from dladmm_tpu_torch.models.api import resolve_forward

    m, n = A.shape
    fwd, _ = resolve_forward(m, n, m, b.shape[0], device=b.device)
    x, e, _ = fwd(params, A, b)
    recon = x @ A.T
    return torch.mean((recon - tgt_res) ** 2) + torch.mean((e - tgt_noise) ** 2)


def denoise_grad(params, A, b, tgt_res, tgt_noise, layer_weights=None):
    """(loss, gradients) of denoise_loss with respect to the params."""
    from dladmm_tpu_torch.models.unroll import DLADMMParams

    leaves = [p.detach().requires_grad_() for p in params]
    loss = denoise_loss(DLADMMParams(*leaves), A, b, tgt_res, tgt_noise, layer_weights)
    return loss.detach(), DLADMMParams(*torch.autograd.grad(loss, leaves))


def make_denoise_step(optimizer, A, images, *, density=0.1, patch=8, stride=4, mode="denoise",
                      layer_weights=None):
    """The denoiser's training step: (state, gen) -> (state, loss). One
    call corrupts every image in ``images`` anew from ``gen`` and builds
    the patch batch (_make_patch_batch), takes denoise_grad and applies
    the optimizer (train/loop._apply). Traced as ``train.step``, holding
    ``train.data`` (the patch batch) and then ``train.optimizer``
    (utils/profiling.span)."""
    from dladmm_tpu_torch.train.loop import _apply

    def step(state, gen):
        with profiling.span("train.step"):
            with profiling.span("train.data"):
                b, tr, tn = _make_patch_batch(gen, images, density, patch, stride, mode)
            loss, grads = denoise_grad(state.params, A, b, tr, tn, layer_weights)
            return _apply(optimizer, state, grads), loss

    return step


def train_denoiser(
    A,
    images,
    *,
    K=15,
    steps=400,
    lr=1e-3,
    density=0.1,
    patch=8,
    stride=4,
    seed=0,
    log_every=100,
    mode="denoise",
    layer_loss=None,
):
    """Train D-LADMM on patch data on A's device; returns the trained
    params. Each step (make_denoise_step) corrupts every training image
    anew from one generator seeded with ``seed``. layer_loss="uniform"
    (or "linear") deep-supervises the reconstruction at every layer; None
    keeps the final-layer reconstruction loss."""
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.train.loop import _layer_weights, adam, make_train_state

    params = init_dladmm_params(A, K=K, beta=1.0)
    optimizer = adam(lr)  # optax.adam(lr) in the JAX package
    state = make_train_state(params, optimizer)
    step = make_denoise_step(optimizer, A, images, density=density, patch=patch, stride=stride, mode=mode,
                             layer_weights=_layer_weights(layer_loss, K, A.dtype, A.device))
    gen = torch.Generator(device=A.device).manual_seed(seed)
    for i in range(steps):
        state, loss = step(state, gen)
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i+1} loss {float(loss):.5f}", file=sys.stderr)
    return state.params


def save_denoiser(path, params, A) -> None:
    """Persist a trained denoiser (the net and its patch dictionary) as
    one .npz, in the JAX package's layout (keys ``A`` and the
    DLADMMParams fields): either package loads the other's."""
    np.savez(path, A=A.detach().cpu().numpy(),
             **{f: v.detach().cpu().numpy() for f, v in params._asdict().items()})


def load_denoiser(path, device=None):
    """Inverse of save_denoiser (either package's file): (params, A) on
    ``device``."""
    from dladmm_tpu_torch.models.unroll import DLADMMParams
    from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

    d = np.load(path)
    params = params_from_numpy(*(d[f] for f in DLADMMParams._fields), device=device)
    return params, torch.as_tensor(np.array(d["A"]), dtype=torch.float32, device=device)


def _load_gray_image(spec: str, what: str = "--input-image", device=None):
    """Grayscale image from ``file.npy`` or ``file.npz[:key]``, float32 in
    [0, 1] on ``device``. Integer arrays are rescaled by their dtype's
    range; float arrays must already be in [0, 1]."""
    from dladmm_tpu_torch.data.synthetic import load_array_spec

    raw = np.asarray(load_array_spec(spec))
    if raw.ndim != 2:
        raise SystemExit(f"{what} must be 2-D grayscale; got {raw.shape}")
    if np.issubdtype(raw.dtype, np.integer):
        arr = raw.astype(np.float32) / np.iinfo(raw.dtype).max
    else:
        arr = raw.astype(np.float32)
        if arr.min() < 0.0 or arr.max() > 1.0:
            raise SystemExit(
                f"{what}: float values must be in [0, 1] (got "
                f"[{arr.min():.3g}, {arr.max():.3g}]); rescale first"
            )
    return torch.as_tensor(arr, device=device)


def _load_mask(spec: str, device=None):
    """Known-observation mask from ``file.npy``/``file.npz[:key]``:
    nonzero = observed (bool, 0/1 or 0/255 alike)."""
    from dladmm_tpu_torch.data.synthetic import load_array_spec

    raw = np.asarray(load_array_spec(spec))
    if raw.ndim != 2:
        raise SystemExit(f"--mask must be 2-D; got {raw.shape}")
    return torch.as_tensor((raw != 0).astype(np.float32), device=device)


@torch.no_grad()
def denoise_image(params, A, noisy, *, patch=8, stride=4, mask=None):
    """Restore one image with a trained net on its device; returns the
    reconstruction. With a known observation ``mask`` (inpaint mode) the
    observed pixels are kept from the input and only the missing ones
    filled in."""
    from dladmm_tpu_torch.data.images import extract_patches, patch_dc, reconstruct_from_patches
    from dladmm_tpu_torch.models.api import resolve_forward

    p_noisy = extract_patches(noisy, patch, stride)
    dc = patch_dc(p_noisy)
    m, n = A.shape
    fwd, _ = resolve_forward(m, n, m, p_noisy.shape[0], device=noisy.device)
    x, _, _ = fwd(params, A, p_noisy - dc)
    clean_patches = x @ A.T + dc
    out = reconstruct_from_patches(clean_patches, noisy.shape[0], patch, stride)
    if mask is not None:
        out = mask * noisy + (1.0 - mask) * out
    return torch.clamp(out, 0.0, 1.0)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="tiny run for CI")
    ap.add_argument("--mode", choices=("denoise", "inpaint"), default="denoise",
                    help="impulse-noise removal or known-mask pixel inpainting")
    ap.add_argument("--dict", dest="dictionary", choices=("dct", "learned"), default="dct",
                    help="overcomplete 2-D DCT, or learned from clean training "
                    "patches (FISTA+MOD, data/dictionary.py)")
    ap.add_argument("--dict-mat", default=None,
                    help="load the dictionary from a .mat fixture (the reference's "
                    "learned-dictionary format; data/fixtures.py) instead of --dict")
    ap.add_argument("--density", type=float, default=0.1)
    ap.add_argument("--layer-loss", choices=["uniform", "linear", "none"], default="none",
                    help="deep-supervise the reconstruction at every layer (uniform "
                    "or final-heavy linear gamma_k ramp; train/loop._layer_weights)")
    ap.add_argument("--layers", type=int, default=15)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--images", type=int, default=4)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None, metavar="NET.npz",
                    help="persist the trained denoiser (net + dictionary) for reuse")
    ap.add_argument("--load", default=None, metavar="NET.npz",
                    help="reuse a --save'd denoiser instead of training (dictionary "
                    "flags are rejected: the saved net carries its own A)")
    ap.add_argument("--input-image", default=None, metavar="IMG.npy[:key]",
                    help="restore this 2-D grayscale array (an ALREADY-corrupted "
                    "user image) instead of the synthetic benchmark; inpaint mode "
                    "reads the known-pixel mask from --mask")
    ap.add_argument("--mask", default=None, metavar="MASK.npy[:key]",
                    help="known-observation mask (1 = observed) for --input-image in inpaint mode")
    ap.add_argument("--output-image", default=None, metavar="OUT.npy",
                    help="write the --input-image reconstruction here")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.dict_mat and args.dictionary == "learned":
        ap.error("--dict-mat and --dict=learned are mutually exclusive: the "
                 "fixture would be silently re-learned away")
    if args.load and (args.dict_mat or args.dictionary == "learned"):
        ap.error("--load carries its own dictionary; drop --dict/--dict-mat")
    if args.load and args.save:
        ap.error("--load skips training, so there is nothing to --save")
    if args.mask and not args.input_image:
        ap.error("--mask only applies to --input-image")
    if args.input_image and args.mode == "inpaint" and not args.mask:
        ap.error("inpaint mode needs --mask with --input-image")
    if args.quick:
        args.steps, args.images, args.size, args.layers = 60, 2, 64, 8

    from dladmm_tpu_torch.data.dictionary import dct_dictionary, learn_dictionary
    from dladmm_tpu_torch.data.images import extract_patches, synthetic_image
    from dladmm_tpu_torch.utils.platform import resolve_device

    device = resolve_device()
    A = dct_dictionary(patch=8, atoms_per_dim=16, device=device)
    if args.dict_mat:
        from dladmm_tpu_torch.data.fixtures import load_mat_dictionary

        A = load_mat_dictionary(args.dict_mat, device=device)
        if A.shape[0] != 64:
            raise SystemExit(
                f"--dict-mat dictionary has {A.shape[0]} rows; need "
                "patch*patch = 64 for the 8x8 patch pipeline"
            )
    seed_train, seed_test = child_seeds(args.seed)
    g_test = torch.Generator(device=device).manual_seed(seed_test)

    if args.load:
        params, A = load_denoiser(args.load, device)
        print(f"loaded denoiser {args.load}: K={params.K}, A {tuple(A.shape)}", file=sys.stderr)
        return _apply_or_benchmark(args, params, A, g_test)

    train_imgs = [synthetic_image(args.size, device=device) for _ in range(args.images)]
    if args.dictionary == "learned":
        # Learn from CLEAN training patches (zero-mean), DCT init.
        clean_p = torch.cat([extract_patches(img, 8, 4) for img in train_imgs])
        clean_p = clean_p - torch.mean(clean_p, dim=1, keepdim=True)
        A = learn_dictionary(clean_p, A, n_atoms=A.shape[1], outer=4 if args.quick else 12)
        print(f"learned dictionary: {tuple(A.shape)} from {clean_p.shape[0]} clean patches", file=sys.stderr)

    params = train_denoiser(
        A, train_imgs, K=args.layers, steps=args.steps, density=args.density, mode=args.mode,
        layer_loss=None if args.layer_loss == "none" else args.layer_loss,
        seed=seed_train,
    )
    if args.save:
        save_denoiser(args.save, params, A)
        print(f"saved denoiser to {args.save}", file=sys.stderr)
    return _apply_or_benchmark(args, params, A, g_test)


def _apply_or_benchmark(args, params, A, g_test) -> int:
    """Shared tail: restore the user's --input-image, or run the 3-image
    synthetic PSNR benchmark (corruptions drawn from ``g_test``)."""
    from dladmm_tpu_torch.data.images import synthetic_image
    from dladmm_tpu_torch.metrics.core import psnr
    from dladmm_tpu_torch.models.api import kernel_route

    device = A.device
    if args.input_image:
        noisy = _load_gray_image(args.input_image, device=device)
        mask = _load_mask(args.mask, device=device) if args.mask else None
        recon = denoise_image(params, A, noisy, mask=mask)
        if args.output_image:
            np.save(args.output_image, recon.cpu().numpy())
        print(json.dumps({
            "mode": args.mode,
            "input_image": args.input_image,
            "shape": list(noisy.shape),
            "output_image": args.output_image,
        }))
        return 0

    results = []
    for i in range(3):
        clean = synthetic_image(args.size, device=device)
        noisy, mask = _corrupt(g_test, clean, args.mode, args.density)
        recon = denoise_image(params, A, noisy, mask=mask)
        results.append({
            "image": i,
            "psnr_noisy_db": round(float(psnr(noisy, clean)), 2),
            "psnr_denoised_db": round(float(psnr(recon, clean)), 2),
        })
        print(f"image {i}: noisy {results[-1]['psnr_noisy_db']} dB -> "
              f"denoised {results[-1]['psnr_denoised_db']} dB")
    mean_gain = sum(r["psnr_denoised_db"] - r["psnr_noisy_db"] for r in results) / len(results)
    print(json.dumps({
        "mode": args.mode,
        "dict": "loaded" if args.load else args.dictionary,
        "results": results,
        "mean_psnr_gain_db": round(mean_gain, 2),
        "route": kernel_route(device),
        "device": str(device),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
