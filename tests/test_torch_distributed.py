"""Port parity for data-parallel training and serving on torch.distributed
(parallel/, train/loop.fit_sharded, serve.ShardedInferenceServer), on
the CPU.

One spawn of 2 gloo ranks and one of 4 run every data-parallel case
(this file run as a script, one process a rank, as
``python -m torch.distributed.run`` would start them); rank 0 writes the
results, and the tests hold them against:

  * the port's single-process step on the global batch, 3 steps (5 for
    ZeRO-1): the replicated-optimizer step (final-layer loss through the
    kernels' plain versions; deep supervision with the int8 sweep;
    general B), the fused step (fp32 with a binding delayed clip; bf16
    deep supervision) and ZeRO-1 (the chain and the dense fused sweep,
    a binding exact clip);
  * the JAX package's make_dp_train_step on a virtual mesh of D CPU
    devices, one step;
  * the port's evaluate on the global batch (make_dp_eval).

Tolerances are the JAX package's (tests/test_distributed.py): loss rtol
1e-5, params rtol 5e-5 / atol 1e-6. As in tests/test_torch_fused_adam.py,
elements in Adam's eps region (a first gradient not zero and below
100 eps, cancellation noise that a summation order moves by about 1%)
are held within 1e-2 * lr and must be fewer than 5% of a leaf. With int8
moments a last-bit difference may move one code by one step, which moves
that element's update by under 1e-3 of lr a step: atol 1e-3 * lr * steps
there (tests/test_torch_training.py's rule).

fit_sharded runs end to end on 2 ranks with a resume (replicated, ZeRO-1
and fused), and ``python -m torch.distributed.run`` drives run.py's
general_b_dp preset on 4. ShardedInferenceServer is held against
InferenceServer in one process, its parts on the CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

M, N, K, S, D_B = 32, 64, 4, 16, 40
LR = 1e-3
HERE = Path(__file__).resolve()
REPO = HERE.parent.parent
BF16_CASES = ("fused_bf16_deep",)


def _problem():
    rng = np.random.default_rng(0)

    def dictionary(m, n):
        A = rng.normal(size=(m, n)).astype(np.float32)
        return A / np.linalg.norm(A, axis=0, keepdims=True)

    A, B = dictionary(M, N), dictionary(M, D_B)
    from dladmm_tpu_torch.models.unroll import init_dladmm_params

    def perturbed(params):
        return [np.asarray(v) + 0.02 * np.abs(np.asarray(v)).mean() * rng.normal(size=v.shape).astype(np.float32)
                for v in params]

    leaves = perturbed(init_dladmm_params(torch.as_tensor(A), K=K))
    leaves_b = perturbed(init_dladmm_params(torch.as_tensor(A), torch.as_tensor(B), K=K))

    def batch(Bm=None, d=M):
        x = ((rng.random((S, N)) < 0.1) * rng.normal(size=(S, N))).astype(np.float32)
        e = ((rng.random((S, d)) < 0.1) * rng.normal(size=(S, d))).astype(np.float32)
        return [(x @ A.T + (e if Bm is None else e @ Bm.T)).astype(np.float32), x, e]

    batches = [batch() for _ in range(5)]
    batches_b = [batch(B, D_B) for _ in range(3)]
    return dict(A=A, B=B, leaves=leaves, leaves_b=leaves_b, batches=batches, batches_b=batches_b)


# -- the cases, shared by the ranks and the single-process references -------------


def _case_setup(name, prob):
    """(params, batches, B, step builder kwargs) of a case; builders take
    ``mesh`` (None: the single-process reference on the global batch)."""
    from dladmm_tpu_torch.models import api
    from dladmm_tpu_torch.train import loop
    from dladmm_tpu_torch.train.qadam_cuda import QAdamFused
    from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

    general = name == "general_b"
    leaves = prob["leaves_b"] if general else prob["leaves"]
    batches = prob["batches_b"] if general else prob["batches"][: 5 if name.startswith("zero1") else 3]
    B = torch.as_tensor(prob["B"]) if general else None
    lw = torch.full((K,), 1.0 / K) if name in ("deep_int8", "fused_bf16_deep") else None
    final_fwd = api.select_forward(M, N, M, S, device="cpu")[0]
    traj_fwd = api.select_forward(M, N, M, S, need_trajectory=True, device="cpu")[0]
    spec = {
        "final": dict(kind="dp", opt=lambda: loop.adam(LR), fwd=final_fwd),
        "deep_int8": dict(kind="dp", opt=lambda: QAdamFused(LR, moment_fmt="int8", clip_norm=1.0), fwd=traj_fwd),
        "general_b": dict(kind="dp", opt=lambda: loop.adam(LR), fwd=None),
        "fused_clip": dict(kind="fused", clip=1e-3, dtype=None),
        "fused_bf16_deep": dict(kind="fused", clip=1.0, dtype=torch.bfloat16),
        "zero1_chain": dict(kind="zero1", opt=lambda: loop.adam(LR), clip=0.05, fwd=final_fwd),
        "zero1_dense": dict(kind="zero1", opt=lambda: QAdamFused(LR, moment_fmt="float32"), clip=0.05,
                            fwd=final_fwd),
        "zero1_int8": dict(kind="zero1", opt=lambda: QAdamFused(LR, moment_fmt="int8"), clip=0.05, fwd=final_fwd),
    }[name]
    return params_from_numpy(*leaves), batches, B, lw, spec


def _run_case(name, prob, mesh=None):
    """Losses, final params (and the first step's) of a case: on the data
    ranks (each its rows of every batch) or, mesh None, the single-process
    reference on the global batch."""
    from dladmm_tpu_torch.data.synthetic import SyntheticBatch
    from dladmm_tpu_torch.parallel import collectives as coll
    from dladmm_tpu_torch.train import fused_adam, loop

    params, batches, B, lw, spec = _case_setup(name, prob)
    A = torch.as_tensor(prob["A"])
    D, r = (1, 0) if mesh is None else (mesh.shape["data"], mesh.rank)

    def rows(bt):
        return SyntheticBatch(*(torch.as_tensor(v)[r * (S // D): (r + 1) * (S // D)] for v in bt))

    if spec["kind"] == "fused":
        dt = spec["dtype"]
        state = fused_adam.make_fused_adam_state(params, spec["clip"], dt)
        A_c, B_c = (A, B) if dt is None else (A.to(dt), None if B is None else B.to(dt))
        if mesh is None:
            core = fused_adam.make_fused_update_core(lw, LR, clip_norm=spec["clip"], compute_dtype=dt, B=B_c)
            step = lambda st, A_, bt: fused_adam.apply_fused(core, st, A_, bt, dt)  # noqa: E731
        else:
            step = coll.make_dp_fused_adam_step(mesh, lw, LR, clip_norm=spec["clip"], compute_dtype=dt, B=B_c)
    elif spec["kind"] == "dp":
        opt = spec["opt"]()
        state = loop.make_train_state(params, opt)
        A_c = A
        if mesh is None:
            inner = loop.make_train_step_from_batch(opt, A, B=B, layer_weights=lw, forward_fn=spec["fwd"])
            step = lambda st, A_, bt: inner(st, bt)  # noqa: E731
        else:
            step = coll.make_dp_train_step(opt, mesh, layer_weights=lw, forward_fn=spec["fwd"], B=B)
    else:
        opt = spec["opt"]()
        A_c = A
        if mesh is None and name == "zero1_int8":
            # int8 moments code the flat (rows, 256) view: the reference is
            # ZeRO-1 on one part, whose rows are the D ranks' rows.
            from dladmm_tpu_torch.parallel.mesh import make_mesh

            one = make_mesh(data=1, devices=["cpu"])
            state = coll.make_dp_zero1_state(params, opt, one)
            step = coll.make_dp_zero1_train_step(opt, one, clip_norm=spec["clip"], forward_fn=spec["fwd"])
        elif mesh is None:
            # The reference: the exact global clip, then the same update.
            ref_opt = (loop.chain(loop.clip_by_global_norm(spec["clip"]), opt) if not hasattr(opt, "fused_apply")
                       else type(opt)(LR, moment_fmt=opt.moment_fmt, clip_norm=spec["clip"]))
            state = loop.make_train_state(params, ref_opt)
            inner = loop.make_train_step_from_batch(ref_opt, A, forward_fn=spec["fwd"])
            step = lambda st, A_, bt: inner(st, bt)  # noqa: E731
        else:
            state = coll.make_dp_zero1_state(params, opt, mesh)
            step = coll.make_dp_zero1_train_step(opt, mesh, clip_norm=spec["clip"], forward_fn=spec["fwd"])
    out = {"losses": []}
    for i, bt in enumerate(batches):
        state, loss = step(state, A_c, rows(bt) if mesh is not None else SyntheticBatch(*map(torch.as_tensor, bt)))
        out["losses"].append(float(loss))
        if i == 0:
            out["first"] = [p.clone() for p in state.params]
    out["params"] = [p.clone() for p in state.params]
    if spec["kind"] == "fused":
        out["prev_norm"] = float(state.opt_state.prev_norm)
    if spec["kind"] == "zero1" and mesh is not None:
        out["opt_shapes"] = [tuple(v.shape) for v in coll._leaves(state.opt_state)]
    return out


CASES = ("final", "deep_int8", "general_b", "fused_clip", "fused_bf16_deep", "zero1_chain", "zero1_dense",
         "zero1_int8")


def _fit_cfg(D, **train):
    from dladmm_tpu_torch.utils.config import Config, ProblemConfig, ShardingConfig, TrainConfig

    zero1 = train.pop("zero1", False)
    base = dict(batch=S, steps=8, eval_every=4, eval_batch=32, lr=LR, clip_norm=1.0, lr_schedule="cosine",
                layer_loss="uniform", moment_dtype="float32_pallas")
    base.update(train)
    return Config(name="dp", problem=ProblemConfig(m=M, n=N, K=K), train=TrainConfig(**base),
                  sharding=ShardingConfig(data_axis=D, zero1=zero1))


FITS = {
    "replicated": {},
    "zero1": dict(zero1=True, moment_dtype="float32"),
    "fused": dict(optimizer="fused_adam", clip_mode="delayed", moment_dtype="float32"),
}


def _fits(D, tmp):
    """fit_sharded cold (checkpoints at steps 4 and 8), then resumed from
    its step-4 checkpoint, per FITS entry."""
    from dladmm_tpu_torch.train.loop import fit_sharded

    import torch.distributed as dist

    out = {}
    for name, kw in FITS.items():
        cfg = _fit_cfg(D, **dict(kw))
        ck = os.path.join(tmp, f"ck_{name}")
        cold, hist = fit_sharded(cfg, ckpt_dir=ck)
        ckpt = torch.load(os.path.join(ck, "step_8.pt"), weights_only=True)
        dist.barrier()
        if dist.get_rank() == 0:  # the run cut after its step-4 checkpoint
            os.remove(os.path.join(ck, "step_8.pt"))
        dist.barrier()
        warm, hist2 = fit_sharded(cfg, ckpt_dir=ck, resume=True)
        out[name] = dict(cold=[p.clone() for p in cold], warm=[p.clone() for p in warm],
                         hist=[{k: v for k, v in h.items()} for h in hist],
                         hist2_steps=[h["step"] for h in hist2],
                         ckpt_opt_shapes=[tuple(v.shape) for v in _tensors(ckpt["opt_state"])])
    return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _worker(tmp: str) -> None:
    """One rank: every case on its rows; rank 0 writes the results."""
    from dladmm_tpu_torch.data.synthetic import SyntheticBatch
    from dladmm_tpu_torch.parallel import collectives as coll
    from dladmm_tpu_torch.parallel.mesh import make_mesh
    from dladmm_tpu_torch.parallel.multihost import initialize_distributed
    from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

    torch.set_num_threads(1)
    dev = initialize_distributed()
    assert dev == torch.device("cpu")
    mesh = make_mesh()
    D, r = mesh.shape["data"], mesh.rank
    prob = torch.load(os.path.join(tmp, "problem.pt"), weights_only=False)
    res = {"backend": mesh.backend, "D": D}
    for name in CASES:
        res[name] = _run_case(name, prob, mesh)
    A = torch.as_tensor(prob["A"])
    for label, leaves, bt, B in (("eval", prob["leaves"], prob["batches"][0], None),
                                 ("eval_general_b", prob["leaves_b"], prob["batches_b"][0],
                                  torch.as_tensor(prob["B"]))):
        data = SyntheticBatch(*(torch.as_tensor(v)[r * (S // D): (r + 1) * (S // D)] for v in bt))
        res[label] = coll.make_dp_eval(mesh, B)(params_from_numpy(*leaves), A, data)
    if D == 2:
        res["fits"] = _fits(D, tmp)
    if r == 0:
        torch.save(res, os.path.join(tmp, "result.pt"))


def spawn_ranks(script: Path, world: int, tmp: Path, timeout: float = 300.0) -> list:
    """Run ``script --worker tmp`` as ``world`` gloo ranks on the CPU
    through the package's spawner (parallel/multihost.spawn_ranks: the
    rendezvous TCPStore held by this process on a port the OS picked, a
    deadline, every rank killed at the end); returns each rank's output.
    A spawn that has not ended after ``timeout`` seconds fails its test."""
    from dladmm_tpu_torch.parallel.multihost import spawn_ranks as spawn

    try:
        return spawn([sys.executable, str(script), "--worker", str(tmp)], world, timeout=timeout,
                     env=dict(DLADMM_PLATFORM="cpu", OMP_NUM_THREADS="1", PYTHONPATH=str(REPO)), cwd=str(REPO))
    except TimeoutError as e:
        pytest.fail(str(e))
    except RuntimeError as e:
        raise AssertionError(str(e)[-6000:]) from None


def _spawn(D: int, tmp: Path) -> dict:
    torch.save(_problem(), tmp / "problem.pt")
    logs = spawn_ranks(HERE, D, tmp)
    res = torch.load(tmp / "result.pt", weights_only=False)
    res["log"] = logs[0]
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns, once for the file: {D: rank 0's results}."""
    return {D: _spawn(D, tmp_path_factory.mktemp(f"dp{D}")) for D in (2, 4)}


@pytest.fixture(scope="module")
def prob():
    return _problem()


def _eps_region(first_grads):
    return [(g > 0) & (g < 100 * 1e-8) for g in first_grads]


def _close(got, want, rtol, atol, eps_region=None, what=""):
    names = ("W1", "W2", "theta1", "theta2", "beta")
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(torch.as_tensor(g).float()), np.asarray(torch.as_tensor(w).float())
        if eps_region is not None:
            mask = eps_region[i]
            assert mask.mean() < 5e-2, (names[i], int(mask.sum()))
            np.testing.assert_allclose(g[mask], w[mask], rtol=0, atol=1e-2 * LR, err_msg=f"{what} {names[i]} eps")
            g, w = g[~mask], w[~mask]
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"{what} {names[i]}")


def _first_grads(name, prob):
    """|g| of the case's first update on the global batch, each leaf:
    the single-process gradient, scaled by the exact clip where the case's
    first step clips (a global clip; the delayed clip's first scale is 1)."""
    from dladmm_tpu_torch.train import loop

    params, batches, B, lw, spec = _case_setup(name, prob)
    b, x, e = map(torch.as_tensor, batches[0])
    _, g = loop._value_and_grad(params, (torch.as_tensor(prob["A"]), b, x, e, B, lw),
                                dict(forward_fn=spec.get("fwd")))
    clip = {"deep_int8": 1.0}.get(name, spec.get("clip") if spec["kind"] == "zero1" else None)
    scale = 1.0 if clip is None else min(1.0, clip / float(loop.global_norm(g)))
    return [np.abs(v.numpy()) * scale for v in g]


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_dp_steps_match_single_process(runs, prob, D, case):
    """Each data-parallel step on D ranks against the single-process step
    on the global batch: every step's loss within rtol 1e-5, the final
    params within rtol 5e-5 / atol 1e-6 (eps region aside)."""
    got, want = runs[D][case], _run_case(case, prob)
    if case == "zero1_int8":
        # The state is 1/D of the JAX package's padded (rows, 256) layout.
        from dladmm_tpu_torch.parallel.collectives import _zero1_padded

        total = sum(v.size for v in prob["leaves"])
        rows = _zero1_padded(total, D, True) // 256 // D
        assert got["opt_shapes"] == [(), (rows, 256), (rows,), (rows, 256), (rows,)]
    if case in BF16_CASES:
        # The JAX test's bf16 bound: bf16 gradients near zero change sign
        # under the all-reduce's order, and Adam's first updates are about
        # lr * sign(g), so an element moves by up to 2 * lr a step.
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-2)
        _close(got["params"], want["params"], 1e-3, 2 * LR * len(got["losses"]), what=case)
        return
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    atol = 1e-3 * LR * len(got["losses"]) if case in ("deep_int8", "zero1_int8") else 1e-6
    _close(got["params"], want["params"], 5e-5, atol, _eps_region(_first_grads(case, prob)), case)
    if case == "fused_clip":
        assert got["prev_norm"] > 1e-3  # the delayed clip bound


@pytest.mark.parametrize("D", [2, 4])
def test_dp_step_matches_jax_virtual_mesh(runs, prob, D):
    """The DP step's first update against the JAX package's
    make_dp_train_step on a virtual mesh of D devices (manual backward,
    final-layer loss, fp32 Adam), the JAX test's tolerances."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from dladmm_tpu.data.synthetic import SyntheticBatch as JBatch
    from dladmm_tpu.models.unroll import DLADMMParams as JParams
    from dladmm_tpu.parallel import mesh as pmesh
    from dladmm_tpu.parallel.collectives import make_dp_train_step
    from dladmm_tpu.train.loop import TrainState

    mesh = pmesh.make_mesh(data=D, model=1)
    opt = optax.adam(LR)
    params = jax.device_put(JParams(*map(jnp.asarray, prob["leaves"])), NamedSharding(mesh, P()))
    b, x, e = prob["batches"][0]
    batch = JBatch(jax.device_put(jnp.asarray(b), NamedSharding(mesh, P("data", None))),
                   jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", "model"))),
                   jax.device_put(jnp.asarray(e), NamedSharding(mesh, P("data", None))))
    A = jax.device_put(jnp.asarray(prob["A"]), NamedSharding(mesh, P(None, "model")))
    step = make_dp_train_step(opt, mesh, donate=False)
    state, loss = step(TrainState(params, opt.init(params), jnp.zeros((), jnp.int32)), A, batch)
    got = runs[D]["final"]
    np.testing.assert_allclose(got["losses"][0], float(loss), rtol=1e-5)
    _close(got["first"], [np.asarray(v) for v in state.params], 5e-5, 1e-6,
           _eps_region(_first_grads("final", prob)), "vs jax")


@pytest.mark.parametrize("D", [2, 4])
def test_dp_eval_matches_evaluate(runs, prob, D):
    """make_dp_eval's summed metrics against the port's evaluate on the
    global batch (B = I through the trajectory route, general B the
    plain loop)."""
    from dladmm_tpu_torch.data.synthetic import SyntheticBatch
    from dladmm_tpu_torch.train.loop import evaluate
    from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

    A = torch.as_tensor(prob["A"])
    for label, leaves, bt, B in (("eval", prob["leaves"], prob["batches"][0], None),
                                 ("eval_general_b", prob["leaves_b"], prob["batches_b"][0],
                                  torch.as_tensor(prob["B"]))):
        want = evaluate(params_from_numpy(*leaves), A, SyntheticBatch(*map(torch.as_tensor, bt)), B)
        got = runs[D][label]
        for key in ("nmse_db", "nmse_db_z", "residual"):
            assert got[key] == pytest.approx(want[key], abs=1e-4), (label, key)
        np.testing.assert_allclose(got["nmse_curve_db"], want["nmse_curve_db"], atol=1e-4)


@pytest.mark.parametrize("fit", sorted(FITS))
def test_fit_sharded_end_to_end_with_resume(runs, fit):
    """fit_sharded on 2 gloo ranks: finite evals at steps 4 and 8 on a
    2x1 mesh, the LADMM curve beside; a run cut at step 4 and resumed
    ends bit for bit on the cold run; the ZeRO-1 checkpoint holds the
    whole-vector optimizer state."""
    out = runs[2]["fits"][fit]
    assert [h["step"] for h in out["hist"]] == [4, 8] and out["hist2_steps"] == [8]
    assert all(h["mesh"] == "2x1" and np.isfinite(h["nmse_db"]) and np.isfinite(h["loss"]) for h in out["hist"])
    assert len(out["hist"][-1]["curves"]["ladmm_curve_db"]) == K
    for a, b in zip(out["warm"], out["cold"]):
        assert torch.equal(a, b)
    if fit == "zero1":
        total = M * N * K + M * M * K + N * K + M * K + K
        assert out["ckpt_opt_shapes"] == [(), (total + (-total) % 2,), (total + (-total) % 2,), ()]
    assert "backend gloo (CPU tensors)" in runs[2]["log"]


def test_fit_sharded_zero1_matches_replicated(runs):
    """ZeRO-1 with the exact clip reproduces the replicated DP run's
    metrics (the JAX test's abs 1e-3 dB and rel 1e-4 loss; the replicated
    run on the dense fused sweep, float32_pallas); the fused run trains
    too."""
    fits = runs[2]["fits"]
    assert fits["zero1"]["hist"][-1]["nmse_db"] == pytest.approx(fits["replicated"]["hist"][-1]["nmse_db"], abs=1e-3)
    assert fits["zero1"]["hist"][-1]["loss"] == pytest.approx(fits["replicated"]["hist"][-1]["loss"], rel=1e-4)
    assert np.isfinite(fits["fused"]["hist"][-1]["nmse_db"])


def test_run_cli_general_b_dp_on_four_ranks(tmp_path):
    """run.py's general_b_dp preset through python -m torch.distributed.run
    on 4 CPU ranks (gloo), with --zero1: the mesh, the table and the
    summary line from rank 0 only."""
    env = dict(os.environ, DLADMM_PLATFORM="cpu", OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=4", "-m",
         "dladmm_tpu_torch.run", "--config=general_b_dp", "--steps=4", "--zero1", "--hbm-gb=1"],
        env=env, cwd=str(REPO), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    summaries = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert len(summaries) == 1 and summaries[0]["mesh"] == "4x1"
    assert np.isfinite(summaries[0]["final_nmse_db"])
    assert any("backend gloo" in ln for ln in lines) and any("TOTAL per chip" in ln for ln in lines)


def test_run_cli_sharded_needs_its_ranks(monkeypatch, capsys):
    """A sharded preset in one process is refused with the launch line
    for its data_axis * model_axis ranks: general_b_dp's 4, tp_small's
    4x2 = 8."""
    from dladmm_tpu_torch import run as trun

    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    with pytest.raises(SystemExit):
        trun.main(["--config=general_b_dp", "--steps=1"])
    err = capsys.readouterr().err
    assert "torch.distributed.run --standalone --nproc_per_node=4" in err
    with pytest.raises(SystemExit):
        trun.main(["--config=tp_small", "--steps=1"])
    err = capsys.readouterr().err
    assert "4x2 mesh" in err and "--nproc_per_node=8 -m dladmm_tpu_torch.run --config=tp_small" in err


def test_fit_sharded_validations():
    import dataclasses

    from dladmm_tpu_torch.train.loop import check_sharded, fit_sharded
    from dladmm_tpu_torch.utils.config import ShardingConfig, get_config

    with pytest.raises(RuntimeError, match="nproc_per_node=8"):
        fit_sharded(get_config("tp_small"), device="cpu")
    cfg = _fit_cfg(2)
    bad = {
        "fused_global": dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, optimizer="fused_adam")),
        "zero1_fused": dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, optimizer="fused_adam",
                                                                         clip_mode="delayed"),
                                           sharding=ShardingConfig(data_axis=2, zero1=True)),
        "zero1_delayed": dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, clip_mode="delayed",
                                                                           moment_dtype="float32"),
                                             sharding=ShardingConfig(data_axis=2, zero1=True)),
        "accum": dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, accum_steps=2)),
        "prox": dataclasses.replace(cfg, problem=dataclasses.replace(cfg.problem, prox_z="box")),
        "rows": dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch=15)),
    }
    for name, c in bad.items():
        with pytest.raises(ValueError):
            check_sharded(c)
    with pytest.raises(RuntimeError, match="nproc_per_node=2"):
        fit_sharded(cfg, device="cpu")


def test_fit_sharded_one_rank_from_init_params_equals_fit(prob):
    """fit_sharded at data_axis = 1 in one process (no launcher) from
    init_params ends bit for bit where fit from the same params ends, and
    its LADMM curve is still the LADMM init's (fit's)."""
    import dataclasses

    from dladmm_tpu_torch.models.api import select_forward
    from dladmm_tpu_torch.train.loop import fit, fit_sharded
    from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

    cfg = _fit_cfg(1, steps=4, eval_every=2)
    init = params_from_numpy(*prob["leaves"])
    got, hist = fit_sharded(cfg, init_params=init, device="cpu")
    fwd = select_forward(M, N, M, S, need_trajectory=True, device="cpu")[0]  # fit_sharded's choice
    want, fhist = fit(cfg, forward_fn=fwd, init_params=init, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [h["loss"] for h in hist] == [h["loss"] for h in fhist]
    np.testing.assert_allclose(hist[-1]["curves"]["ladmm_curve_db"], fhist[-1]["curves"]["ladmm_curve_db"],
                               atol=1e-4)


def fit_sharded_small():
    """fit_sharded on the CPU at data_axis = 1, 2 steps."""
    from dladmm_tpu_torch.train.loop import fit_sharded

    return fit_sharded(_fit_cfg(1, steps=2, eval_every=2), device="cpu")


def _gloo_group(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", world_size=1, rank=0)
    return dist


def test_rank_device_resolves_whatever_started_the_group(tmp_path, monkeypatch):
    """With a gloo group the caller started, the rank's device still
    comes from utils/platform.resolve_device: the CPU only where asked
    for (fit_sharded(device="cpu") runs in that group), else the card
    (here absent: it raises, nothing falls back to the CPU); a bare cuda
    maps LOCAL_RANK to a card."""
    from dladmm_tpu_torch.parallel import multihost

    monkeypatch.delenv("DLADMM_PLATFORM", raising=False)
    monkeypatch.setattr(multihost, "_RANK_DEVICE", None)
    dist = _gloo_group(tmp_path)
    try:
        assert multihost.initialize_distributed("cpu") == torch.device("cpu")
        from dladmm_tpu_torch.parallel.mesh import make_mesh

        assert make_mesh(data=1, devices=["cpu"]).devices == (torch.device("cpu"),)
        _, hist = fit_sharded_small()
        assert hist[-1]["mesh"] == "1x1"
        monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
        assert multihost.rank_device() == torch.device("cpu")
        monkeypatch.delenv("DLADMM_PLATFORM")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                multihost.initialize_distributed()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        monkeypatch.setenv("LOCAL_RANK", "6")
        assert multihost.rank_device() == torch.device("cuda", 2)
        assert multihost.rank_device("cuda:1") == torch.device("cuda", 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("local_world,cards,want", [(8, 1, 8), (8, 4, 2), (3, 2, 2), (2, 4, 1)])
def test_ranks_per_card(monkeypatch, local_world, cards, want):
    from dladmm_tpu_torch.parallel.multihost import ranks_per_card

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    assert ranks_per_card(torch.device("cuda", 0)) == want
    assert ranks_per_card(torch.device("cuda", 0), local_world=1) == 1
    assert ranks_per_card("cpu") == 1


def test_fit_sharded_audits_each_rank_against_its_share_of_the_card(monkeypatch):
    """The audit divides the device's memory by the ranks that share it
    (ranks_per_card): a config that fits one rank's 16 GB is refused
    before anything is allocated when 8 ranks share the device; an
    explicit hbm_bytes is the rank's own budget."""
    import dataclasses

    from dladmm_tpu_torch.parallel import multihost
    from dladmm_tpu_torch.train.loop import fit_sharded, sharded_audit
    from dladmm_tpu_torch.utils.config import get_config

    cfg = get_config("multihost")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch=4096, eval_batch=256),
                              sharding=dataclasses.replace(cfg.sharding, data_axis=1, multihost=False))
    total = sharded_audit(cfg, 16e9).total
    assert 16e9 * 0.9 / 8 < total < 16e9 * 0.9
    monkeypatch.setattr(multihost, "ranks_per_card", lambda device, local_world=None: 8)
    with pytest.raises(MemoryError, match="exceeds"):
        fit_sharded(cfg, device="cpu")
    with pytest.raises(MemoryError):
        fit_sharded(cfg, hbm_bytes=total, device="cpu")


def test_host_local_batch_draws_each_rank_its_rows(prob):
    """multihost's batch: each rank draws its own global_batch / D rows
    from its own stream, deterministically, with b = A x* + e*."""
    from dladmm_tpu_torch.parallel.mesh import Mesh
    from dladmm_tpu_torch.parallel.multihost import host_local_batch

    A = torch.as_tensor(prob["A"])
    parts = [host_local_batch(0, 3, A, 16, Mesh({"data": 2, "model": 1}, (torch.device("cpu"),), rank=r))
             for r in (0, 1)]
    again = host_local_batch(0, 3, A, 16, Mesh({"data": 2, "model": 1}, (torch.device("cpu"),), rank=1))
    assert all(p.b.shape == (8, M) and p.x_star.shape == (8, N) for p in parts)
    assert not torch.equal(parts[0].x_star, parts[1].x_star)
    assert all(torch.equal(a, b) for a, b in zip(parts[1], again))
    torch.testing.assert_close(parts[0].b, parts[0].x_star @ A.T + parts[0].e_star)
    with pytest.raises(ValueError):
        host_local_batch(0, 3, A, 15, Mesh({"data": 2, "model": 1}, (torch.device("cpu"),)))


# -- sharded serving ------------------------------------------------------------


@pytest.mark.parametrize("dtype", [None, "bfloat16", "int8"])
@pytest.mark.parametrize("T", [2, 3])
def test_sharded_server_matches_inference_server(prob, dtype, T):
    """Rows split over T parts on the CPU, each the single-device stack,
    gathered: within TOL (1e-4 of max(1, max|ref|)) of InferenceServer on
    the same requests, padding included; general B in float32."""
    from dladmm_tpu_torch.parallel.mesh import make_mesh
    from dladmm_tpu_torch.serve import InferenceServer, ShardedInferenceServer
    from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

    mesh = make_mesh(data=T, devices=["cpu"] * T)
    A = torch.as_tensor(prob["A"])
    params = params_from_numpy(*prob["leaves"])
    cases = [(params, None, prob["batches"][0][0])]
    if dtype is None:
        cases.append((params_from_numpy(*prob["leaves_b"]), torch.as_tensor(prob["B"]), prob["batches_b"][0][0]))
    for p, B, b in cases:
        sharded = ShardedInferenceServer(p, A, mesh, max_batch=32, dtype=dtype, B=B)
        single = InferenceServer(p, A, max_batch=32, dtype=dtype, B=B, device="cpu")
        assert all(S % T == 0 for S in sharded.buckets)
        for rows in (13, 16):
            x, z = sharded.solve(b[:rows])
            xw, zw = single.solve(b[:rows])
            assert x.shape == xw.shape and z.shape == zw.shape and x.dtype == xw.dtype
            for g, w in ((x, xw), (z, zw)):
                g, w = g.float(), w.float()
                assert float((g - w).abs().max()) <= 1e-4 * max(1.0, float(w.abs().max()))


def test_sharded_server_mesh_rules():
    from dladmm_tpu_torch.parallel.mesh import make_mesh, pick_backend
    from dladmm_tpu_torch.serve import ShardedInferenceServer

    with pytest.raises(ValueError, match="exceeds"):
        make_mesh(data=3, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="needs 2 ranks in a process group"):
        make_mesh(data=1, model=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="divisible"):
        ShardedInferenceServer(*_tiny(), make_mesh(data=2, devices=["cpu"] * 2), buckets=(3,))
    assert pick_backend(torch.device("cpu"), 4, 0)[0] == "gloo"
    assert pick_backend(torch.device("cuda", 0), 2, 1)[0] == "gloo"
    assert pick_backend(torch.device("cuda", 0), 4, 4)[0] == "nccl"


def _tiny():
    from dladmm_tpu_torch.models.unroll import init_dladmm_params

    A = torch.eye(8, 16)
    return init_dladmm_params(A, K=2), A


def test_serve_cli_sharded(tmp_path, monkeypatch, capsys):
    """serve --sharded on the CPU (one part): the summary says so and the
    NMSE equals the unsharded serve's."""
    from dladmm_tpu_torch import run as trun
    from dladmm_tpu_torch import serve as tserve

    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    ck = str(tmp_path / "ck")
    assert trun.main(["--config=smoke", "--steps=8", "--ckpt-dir", ck]) == 0
    capsys.readouterr()
    res = {}
    for flag in ([], ["--sharded"]):
        assert tserve.main(["--config=smoke", "--ckpt-dir", ck, "--demo", "64", *flag]) == 0
        res[bool(flag)] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res[True]["sharded"] and res[True]["data_parts"] == 1
    assert res[True]["nmse_db"] == pytest.approx(res[False]["nmse_db"], abs=1e-6)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2])
