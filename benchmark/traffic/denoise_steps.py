"""Closed-loop training of the patch denoiser: the program's own step
(``run_denoise.make_denoise_step``, with the recipe's optimizer from
``train/loop._build_optimizer``), run step after step with no sync
inside the window.

Set-up makes the configuration's images (``images`` copies of the
program's procedural test image, ``data/images.synthetic_image``, at
``size`` x ``size``) and its DCT dictionary (``data/dictionary.
dct_dictionary``) for the program, the same from the frozen copies in
``yardstick/images.py`` for the reference, and the seed's parameters
from the reference's dictionary (``inputs.py``).
Step i corrupts every image anew on the device, from a generator on the
device seeded with the child seed of (seed, i), the seed that
``step_generator(seed, i)`` takes; so a step's data depends on (seed,
step) alone. The batch is every ``patch`` x ``patch`` window at
``stride`` of every image: 4 x 127^2 = 64 516 rows at 512 x 512, and
``train_samples_per_s`` counts them. As in ``train_steps``, the
optimizer's count starts at the mix's ``start_step`` (its moments
fresh), set-up runs the first three steps, and the window follows.

After the window the reference redraws the three steps' corruption from
the same generators (``yardstick/images.salt_pepper``) on its own clean
images, builds the patches by slicing (``reference/denoise.py``) and
runs the loss, on its own dictionary, through ``reference/solver.unroll``
with autograd and plain fp32 Adam (``reference/adam.py``); the numbers
compared are ``train_steps``' (``reference/compare.py``). The control "half_batch" is the reference on
the first half of the rows (the first half of the images); the fault of
that name runs the program's step on the first half of the images.
"""

from __future__ import annotations

from benchmark import inputs
from benchmark.reference import denoise, precision
from benchmark.reference.adam import Adam
from benchmark.reference.optim import B1
from benchmark.traffic import train_steps
from benchmark.traffic.train_steps import FIRST, _flipped, _unchanged
from benchmark.traffic.train_steps_lean import _adam, _at_count
from benchmark.yardstick import images
from benchmark.yardstick.synthetic import step_generator

REHEARSAL = {"config": {"m": 16, "n": 64, "K": 3, "patch": 4, "atoms_per_dim": 8, "size": 16, "images": 2},
             "mix": {"trace_at_s": 0.1, "trace_s": 0.2}}


def step_seed(seed: int, i: int) -> int:
    """The seed of step ``i``'s generator: ``step_generator(seed, i)``'s."""
    return step_generator(seed, i).initial_seed()


class Workload(train_steps.Workload):
    def setup(self) -> None:
        from dladmm_tpu_torch.run_denoise import make_denoise_step  # first: a program without it fails at once

        import torch

        from dladmm_tpu_torch.data.dictionary import dct_dictionary
        from dladmm_tpu_torch.data.images import synthetic_image
        from dladmm_tpu_torch.models.unroll import DLADMMParams
        from dladmm_tpu_torch.train import loop
        from dladmm_tpu_torch.utils.config import TrainConfig

        cfg, r = self.cfg, self.recipe
        if cfg["mode"] != "denoise" or cfg["dictionary"] != "dct":
            raise ValueError("denoise_steps runs the salt-and-pepper denoiser on the DCT dictionary")
        if (cfg["m"], cfg["n"]) != (cfg["patch"] ** 2, cfg["atoms_per_dim"] ** 2):
            raise ValueError("m is patch^2 and n atoms_per_dim^2")
        if self.device.type == "cuda":
            from dladmm_tpu_torch.ops import cuda_build

            cuda_build.build_all([cuda_build.CSRC / s for s in ("unroll.cu", "unroll_bwd.cu")])
        self.torch = torch
        self.A = dct_dictionary(cfg["patch"], cfg["atoms_per_dim"], device=self.device)
        self.images = [synthetic_image(cfg["size"], device=self.device) for _ in range(cfg["images"])]
        self.ref_A = images.dct_dictionary(cfg["patch"], cfg["atoms_per_dim"], device=self.device)
        self.ref_images = [images.synthetic_image(cfg["size"], device=self.device) for _ in range(cfg["images"])]
        side = (cfg["size"] - cfg["patch"]) // cfg["stride"] + 1
        r["batch"] = cfg["images"] * side * side
        self.params = inputs.parameters(cfg, self.ref_A, self.seed)
        t = TrainConfig(**{k: r[k] for k in ("lr", "lr_schedule", "clip_norm", "layer_loss", "moment_dtype")})
        optimizer = loop._build_optimizer(t)
        imgs = self.images[:len(self.images) // 2] if self.fault == "half_batch" else self.images
        step = make_denoise_step(optimizer, self.A, imgs, density=cfg["density"], patch=cfg["patch"],
                                 stride=cfg["stride"], mode=cfg["mode"],
                                 layer_weights=loop._layer_weights(r["layer_loss"], cfg["K"], device=self.device))
        self.step = {"unchanged": _unchanged, "flipped": _flipped}.get(self.fault, lambda s: s)(
            lambda state, i: step(state, self._generator(i)))
        state = loop.make_train_state(DLADMMParams(*(p.clone() for p in self.params)), optimizer)
        self.start = self.mix["start_step"]
        self.state = state._replace(opt_state=_at_count(state.opt_state, self.start), step=self.start)
        self.losses = []
        for i in range(FIRST):
            self._step(self.start + i)
            if i == 0:
                self.first_moments = [mu.clone() for mu in _adam(self.state.opt_state).mu]
            self.losses.append(self.loss)
        self.after = [p.detach().clone() for p in self.state.params]
        self.i = self.start + FIRST

    def _generator(self, i: int):
        return self.torch.Generator(device=self.device).manual_seed(step_seed(self.seed, i))

    def reference(self, tf32: bool = False, half_batch: bool = False) -> dict:
        """The first three steps in the reference: losses, first gradient
        norms as its optimizer got them, each leaf's change and its norm,
        raw gradient norms."""
        cfg, r = self.cfg, self.recipe
        params = [p.clone() for p in self.params]
        opt = Adam(params, r["lr"], self.start)
        out = {"losses": []}
        with precision(tf32):
            for i in range(FIRST):
                gen = self._generator(self.start + i)
                noisy = [images.salt_pepper(gen, img, cfg["density"]) for img in self.ref_images]
                rows = denoise.patch_batch(noisy, self.ref_images, cfg["patch"], cfg["stride"])
                if half_batch:
                    rows = [t[:t.shape[0] // 2] for t in rows]
                value, grads = denoise.loss_and_grads(params, self.ref_A, *rows)
                opt.step(params, grads)
                if i == 0:
                    out["raw"] = [float(g.norm()) for g in grads]
                    out["first"] = [float((mu / (1 - B1)).norm()) for mu in opt.mu]
                out["losses"].append(float(value))
        out["delta"] = [a - p for a, p in zip(params, self.params)]
        out["change"] = [float(d.norm()) for d in out["delta"]]
        return out
