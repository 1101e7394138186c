"""Port parity for tensor parallelism on torch.distributed (model_axis > 1:
parallel/collectives.py's TP half, parallel/mesh.py's model axis,
train/loop.fit_sharded's TP branch, run.py), on the CPU.

One spawn of 4 gloo ranks (this file run as a script, one process a
rank) builds a 2x2 and a 1x4 mesh in the same world and runs both
layouts on each, at the JAX package's test shapes (m = 16, n = 64, K = 6,
S = 16) from a perturbed LADMM init; rank 0 writes the results, gathered
whole, and the tests hold them against:

  * the JAX package on a virtual CPU mesh of the same shape, the same
    numpy inputs: sharded_forward at rtol 2e-5 / atol 1e-6,
    make_sharded_eval's curve, nmse_db_z and residual at 1e-4, and
    make_sharded_train_step's first step: fp32 final-layer loss (loss
    rtol 1e-5, params rtol 5e-5 / atol 1e-6 outside Adam's eps region),
    deep supervision, a binding global clip, bfloat16_sr moments (one
    step: SR touches only the stored moments) and bf16 with
    freeze=("beta",) at the JAX package's bf16 tolerance (loss within 5%
    + 1e-3; an element moves by up to 2 lr when a bf16 gradient near 0
    changes sign);
  * the port's single-process path on the global batch: the raw
    gradients of every leaf (autograd through the plain loop) within
    2e-5 of a leaf's largest value, three steps' losses at rtol 1e-5,
    and three bfloat16_sr steps (the TP update draws each element's SR
    bits at its index in the whole leaf, so it rounds as the single
    process does), with beta equal on every rank.

The same spawn trains fit_sharded end to end on a 2x2 mesh (the smoke
preset, checkpoints at steps 4 and 8) and resumes from step 4; the test
process then serves the checkpoint through the single-device ``serve
--ckpt-dir``. Every refusal of check_sharded and run.py for tensor
parallelism is checked in one process.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

M, N, K, S = 16, 64, 6, 16
LR = 1e-3
CLIP = 0.1  # binds: the first gradient's norm is 0.62
MESHES = ((2, 2), (1, 4))
LAYOUTS = ("sharded_w2", "replicated_w2")
HERE = Path(__file__).resolve()
REPO = HERE.parent.parent


def _problem():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(M, N)).astype(np.float32)
    A /= np.linalg.norm(A, axis=0, keepdims=True)
    from dladmm_tpu_torch.models.unroll import init_dladmm_params

    leaves = [np.asarray(v) + 0.05 * rng.normal(size=v.shape).astype(np.float32)
              for v in init_dladmm_params(torch.as_tensor(A), K=K)]

    def batch():
        x = ((rng.random((S, N)) < 0.1) * rng.normal(size=(S, N))).astype(np.float32)
        e = ((rng.random((S, M)) < 0.1) * rng.normal(size=(S, M))).astype(np.float32)
        return [(x @ A.T + e).astype(np.float32), x, e]

    return dict(A=A, leaves=leaves, batches=[batch() for _ in range(3)])


def _optimizer(case):
    from dladmm_tpu_torch.train import loop
    from dladmm_tpu_torch.train.qmoments import adam_qmoments

    if case == "sr":
        return adam_qmoments(LR, moment_dtype="bfloat16_sr")
    if case == "clip":
        return loop.chain(loop.clip_by_global_norm(CLIP), loop.adam(LR))
    if case == "delayed":
        return loop.chain(loop.delayed_clip_by_global_norm(CLIP), loop.adam(LR))
    return loop.adam(LR)


# case: (steps, deep supervision, compute dtype, freeze)
CASES = {
    "fp32": (3, False, None, ()),
    "deep": (1, True, None, ()),
    "clip": (1, False, None, ()),
    "delayed": (3, False, None, ()),
    "sr": (3, False, None, ()),
    "bf16_freeze": (1, False, torch.bfloat16, ("beta",)),
}


def _lw():
    return torch.full((K,), 1.0 / K)


# -- one rank -------------------------------------------------------------------


def _rank_cases(prob, data, model, layout):
    """Forward, eval, raw gradients and every step case on a data x model
    mesh, gathered whole."""
    from dladmm_tpu_torch.data.synthetic import SyntheticBatch
    from dladmm_tpu_torch.parallel import collectives as coll
    from dladmm_tpu_torch.parallel.mesh import gather_params_tp, make_mesh, model_slice, shard_params_tp
    from dladmm_tpu_torch.train import loop
    from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

    mesh = make_mesh(data=data, model=model)
    A = torch.as_tensor(prob["A"])
    A_t = model_slice(A, mesh).contiguous()
    whole = params_from_numpy(*prob["leaves"])
    shards = shard_params_tp(whole, mesh, layout)

    def local(bt):
        n = S // data
        r = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
        b, x, e = (torch.as_tensor(v)[r] for v in bt)
        return SyntheticBatch(b, model_slice(x, mesh).contiguous(), e)

    out = {}
    x, z, lam = coll.sharded_forward(mesh, shards, A_t, local(prob["batches"][0]).b, layout)
    split = layout == "sharded_w2"
    out["forward"] = [coll.gather_blocks(mesh, x), coll.gather_blocks(mesh, z, split),
                      coll.gather_blocks(mesh, lam, split)]
    out["eval"] = coll.make_sharded_eval(mesh, layout)(shards, A_t, local(prob["batches"][0]))
    timer = coll.CollectiveTimer()
    opt = loop.adam(LR)
    coll.make_sharded_train_step(opt, mesh, layout, timer=timer)(loop.make_train_state(shards, opt), A_t,
                                                                 local(prob["batches"][0]))
    out["collectives"] = timer.calls
    tp = coll._TP(mesh)
    for deep in (False, True):
        bt = local(prob["batches"][0])
        loss, grads = coll._tp_value_and_grad(tp, shards, A_t, bt.b, bt.x_star, bt.e_star, layout,
                                              _lw() if deep else None)
        stacked = type(whole)(*(torch.stack(gs) for gs in zip(*grads)))
        out[f"grads_{'deep' if deep else 'final'}"] = (float(loss), gather_params_tp(stacked, mesh, layout))
    for case, (steps, deep, dt, freeze) in CASES.items():
        opt = _optimizer(case)
        state = loop.make_train_state(shards, opt, dt)
        step = coll.make_sharded_train_step(opt, mesh, layout, dt, freeze, _lw() if deep else None)
        A_c = A_t if dt is None else A_t.to(dt)
        losses = []
        for i in range(steps):
            state, loss = step(state, A_c, local(prob["batches"][i]))
            losses.append(float(loss))
            if i == 0 and case == "sr":
                mu_first = gather_params_tp(type(whole)(*(v.float() for v in state.opt_state[0].mu)), mesh, layout)
            if i == 0:  # the step updates the state in place: keep copies
                first = type(whole)(*(v.clone() for v in gather_params_tp(state.params, mesh, layout)))
        res = dict(losses=losses, first=first, params=gather_params_tp(state.params, mesh, layout))
        if case == "sr":
            # beta and its moments on every rank, and the stored moments
            import torch.distributed as dist

            mine = torch.cat([state.params.beta, state.opt_state[0].mu.beta.float(),
                              state.opt_state[0].nu.beta.float()])
            every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
            dist.all_gather(every, mine)
            res["beta_ranks"] = every
            res["mu"] = mu_first
        if dt is not None:
            res["cp_dtype"] = str(state.compute_params.W1.dtype)
        out[case] = res
    return out


def _fit_cfg():
    from dladmm_tpu_torch.utils.config import ShardingConfig, get_config

    cfg = get_config("smoke")
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, steps=8, eval_every=4),
                               sharding=ShardingConfig(data_axis=2, model_axis=2))


def _fit(tmp):
    """fit_sharded on the 2x2 mesh with checkpoints, cut after step 4 and
    resumed."""
    import torch.distributed as dist

    from dladmm_tpu_torch.parallel.mesh import gather_params_tp, make_mesh
    from dladmm_tpu_torch.train.loop import fit_sharded

    cfg = _fit_cfg()
    ck = os.path.join(tmp, "ck")
    cold, hist = fit_sharded(cfg, ckpt_dir=ck)
    dist.barrier()
    if dist.get_rank() == 0:
        os.remove(os.path.join(ck, "step_8.pt"))
    dist.barrier()
    warm, hist2 = fit_sharded(cfg, ckpt_dir=ck, resume=True)
    mesh = make_mesh(data=2, model=2)
    return dict(cold=gather_params_tp(cold, mesh), warm=gather_params_tp(warm, mesh), ckpt=ck,
                hist=[{k: v for k, v in h.items() if k != "curves"} for h in hist],
                curves=hist[-1]["curves"], hist2=[{k: v for k, v in h.items() if k != "curves"} for h in hist2])


def _worker(tmp: str) -> None:
    from dladmm_tpu_torch.parallel.multihost import initialize_distributed

    torch.set_num_threads(1)
    assert initialize_distributed() == torch.device("cpu")
    import torch.distributed as dist

    prob = torch.load(os.path.join(tmp, "problem.pt"), weights_only=False)
    res = {(d, t, layout): _rank_cases(prob, d, t, layout) for d, t in MESHES for layout in LAYOUTS}
    res["fit"] = _fit(tmp)
    from dladmm_tpu_torch.parallel.mesh import make_mesh, model_slice
    from dladmm_tpu_torch.parallel.multihost import host_local_batch

    mesh = make_mesh(data=2, model=2)
    mine = host_local_batch(0, 3, model_slice(torch.as_tensor(prob["A"]), mesh).contiguous(), 16, mesh)
    every = [[torch.empty_like(v) for v in mine] for _ in range(4)]
    for j, v in enumerate(mine):
        dist.all_gather([e[j] for e in every], v.contiguous())
    res["host_local"] = every
    if dist.get_rank() == 0:
        torch.save(res, os.path.join(tmp, "result.pt"))


# -- the tests --------------------------------------------------------------------


@pytest.fixture(scope="module")
def prob():
    return _problem()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, prob):
    from test_torch_distributed import spawn_ranks

    tmp = tmp_path_factory.mktemp("tp")
    torch.save(prob, tmp / "problem.pt")
    spawn_ranks(HERE, 4, tmp)
    return torch.load(tmp / "result.pt", weights_only=False)


def _np(v):
    return np.asarray(torch.as_tensor(v).float())


def _close(got, want, rtol, atol, eps_region=None, what=""):
    names = ("W1", "W2", "theta1", "theta2", "beta")
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), np.asarray(w, dtype=np.float32)
        if eps_region is not None:
            mask = eps_region[i]
            assert mask.mean() < 5e-2, (names[i], int(mask.sum()))
            np.testing.assert_allclose(g[mask], w[mask], rtol=0, atol=1e-2 * LR, err_msg=f"{what} {names[i]} eps")
            g, w = g[~mask], w[~mask]
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"{what} {names[i]}")


def _single(prob, deep=False):
    """The port's single-process loss and raw gradients on the global
    batch (autograd through the plain loop)."""
    from dladmm_tpu_torch.train import loop
    from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

    b, x, e = map(torch.as_tensor, prob["batches"][0])
    return loop._value_and_grad(params_from_numpy(*prob["leaves"]),
                                (torch.as_tensor(prob["A"]), b, x, e, None, _lw() if deep else None), {"vjp": "xla"})


def _eps_region(prob, case="fp32"):
    """Adam's eps region of the first update: a gradient not zero and
    below 100 eps (scaled by the clip where it binds)."""
    from dladmm_tpu_torch.train import loop

    _, g = _single(prob, deep=case == "deep")
    scale = min(1.0, CLIP / float(loop.global_norm(g))) if case == "clip" else 1.0
    return [(np.abs(v.numpy()) * scale > 0) & (np.abs(v.numpy()) * scale < 100 * 1e-8) for v in g]


def _jax_mesh_inputs(shape, layout, prob, dtype=None):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from dladmm_tpu.data.synthetic import SyntheticBatch as JBatch
    from dladmm_tpu.models.unroll import DLADMMParams as JParams
    from dladmm_tpu.parallel import mesh as pmesh
    from dladmm_tpu.parallel.collectives import B_SPEC, X_SPEC, Z_SPEC

    mesh = pmesh.make_mesh(data=shape[0], model=shape[1])
    sh = pmesh.param_shardings_tp(mesh, layout)
    params = jax.device_put(JParams(*map(jnp.asarray, prob["leaves"])), sh["params"])
    A = jax.device_put(jnp.asarray(prob["A"]), sh["A"])
    b, x, e = prob["batches"][0]
    put = lambda v, spec: jax.device_put(jnp.asarray(v), NamedSharding(mesh, spec))  # noqa: E731
    return mesh, params, A, JBatch(put(b, B_SPEC), put(x, X_SPEC), put(e, Z_SPEC))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_forward_and_eval_match_jax(runs, prob, shape, layout):
    """sharded_forward's gathered x, z, lam and make_sharded_eval's
    metrics against the JAX package's on a virtual mesh of the shape."""
    import jax

    from dladmm_tpu.parallel.collectives import make_sharded_eval, sharded_forward

    mesh, params, A, batch = _jax_mesh_inputs(shape, layout, prob)
    got = runs[(*shape, layout)]
    want = sharded_forward(mesh, params, A, batch.b, layout)
    for g, w in zip(got["forward"], want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-5, atol=1e-6)
    ev = jax.device_get(make_sharded_eval(mesh, layout)(params, A, batch))
    np.testing.assert_allclose(got["eval"]["nmse_curve_db"], np.asarray(ev["nmse_curve_db"]), rtol=1e-4, atol=1e-4)
    for key in ("nmse_db", "nmse_db_z", "residual"):
        np.testing.assert_allclose(got["eval"][key], float(ev[key]), rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", ["fp32", "deep", "clip", "sr", "bf16_freeze"])
def test_sharded_train_step_matches_jax(runs, prob, shape, layout, case):
    """The TP step's first update against the JAX package's
    make_sharded_train_step on the same mesh: optax.adam, the deep
    supervision weights, clip_by_global_norm, the bfloat16_sr moments,
    bf16 with beta frozen."""
    import jax
    import jax.numpy as jnp
    import optax

    from dladmm_tpu.parallel.collectives import make_sharded_train_step
    from dladmm_tpu.train.loop import TrainState
    from dladmm_tpu.train.qmoments import adam_qmoments

    _, deep, dt, freeze = CASES[case]
    opt = {"clip": optax.chain(optax.clip_by_global_norm(CLIP), optax.adam(LR)),
           "sr": adam_qmoments(LR, moment_dtype="bfloat16_sr")}.get(case, optax.adam(LR))
    mesh, params, A, batch = _jax_mesh_inputs(shape, layout, prob)
    jdt = None if dt is None else jnp.bfloat16
    cp = None if jdt is None else jax.tree.map(lambda v: v.astype(jdt), params)
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32), cp)
    step = make_sharded_train_step(opt, mesh, layout, compute_dtype=jdt, freeze=freeze,
                                   layer_weights=jnp.full((K,), 1.0 / K) if deep else None, donate=False)
    state, loss = step(state, A if jdt is None else A.astype(jdt), batch)
    got = runs[(*shape, layout)][case]
    want = [np.asarray(v) for v in state.params]
    if dt is not None:
        assert abs(got["losses"][0] - float(loss)) < 0.05 * abs(float(loss)) + 1e-3
        _close(got["first"], want, 1e-3, 2 * LR, what=case)
        np.testing.assert_array_equal(_np(got["first"].beta), prob["leaves"][4])
        assert not np.allclose(_np(got["first"].W1), prob["leaves"][0])
        assert got["cp_dtype"] == "torch.bfloat16"
        return
    np.testing.assert_allclose(got["losses"][0], float(loss), rtol=1e-5)
    _close(got["first"], want, 5e-5, 1e-6, _eps_region(prob, case), case)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("deep", [False, True])
def test_raw_gradients_match_single_process(runs, prob, shape, layout, deep):
    """Every leaf's gradient on the TP mesh (sharded leaves gathered,
    replicated ones as rank 0 holds them) within 2e-5 of the leaf's
    largest value of the single-process autograd gradient; the loss at
    rtol 1e-5."""
    loss, grads = runs[(*shape, layout)][f"grads_{'deep' if deep else 'final'}"]
    want_loss, want = _single(prob, deep)
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    for name, g, w in zip(want._fields, grads, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 2e-5 * scale, name


def _single_steps(prob, case):
    from dladmm_tpu_torch.data.synthetic import SyntheticBatch
    from dladmm_tpu_torch.train import loop
    from dladmm_tpu_torch.utils.torch_compat import params_from_numpy

    steps, deep, _, _ = CASES[case]
    opt = _optimizer(case)
    state = loop.make_train_state(params_from_numpy(*prob["leaves"]), opt)
    step = loop.make_train_step_from_batch(opt, torch.as_tensor(prob["A"]), layer_weights=_lw() if deep else None,
                                           vjp="xla")
    losses = []
    for i in range(steps):
        state, loss = step(state, SyntheticBatch(*map(torch.as_tensor, prob["batches"][i])))
        losses.append(float(loss))
    return losses, state


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", ["fp32", "delayed", "sr"])
def test_three_steps_match_single_process(runs, prob, shape, layout, case):
    """Three TP steps against the port's single-process steps on the
    global batch: losses at rtol 1e-5, params at rtol 5e-5 / atol 1e-6
    (Adam's eps region apart) for fp32 Adam, the delayed clip (its norm
    the whole gradient's, binding from step 2) and bfloat16_sr moments
    (the same SR bits element for element; a moment whose two sums differ
    in the last fp32 bit can still round to the other bf16 neighbour,
    which moves it by 2^-8 of itself and that element's update by under
    4e-3 lr a step: atol 4e-3 lr a step there, the int8 rule of
    tests/test_torch_distributed.py). Under SR beta, its moments and its
    updates are equal on every rank, and each stored first moment of the
    first step is within one bf16 ulp of the fp32 one, rounded up about as
    often as down."""
    got = runs[(*shape, layout)][case]
    losses, state = _single_steps(prob, case)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    atol = 4e-3 * LR * len(losses) if case == "sr" else 1e-6
    _close(got["params"], [v.numpy() for v in state.params], 5e-5, atol, _eps_region(prob), case)
    if case == "sr":
        first = got["beta_ranks"][0]
        assert all(torch.equal(first, v) for v in got["beta_ranks"])
        _, grads = _single(prob)
        mu, ref = _np(got["mu"].W1), 0.1 * grads.W1.numpy()
        assert np.all(np.abs(mu - ref) <= np.abs(ref) * 2.0 ** -7 * 1.001)
        moved = mu != ref
        up = np.mean((mu > ref)[moved])
        assert 0.4 < up < 0.6, up


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", MESHES)
def test_collectives_a_step(runs, shape, layout):
    """The TP step's collectives, counted by a CollectiveTimer: sharded_w2
    has a layer's partial A x summed and z gathered in the forward, and
    the backward's sums for u, v and z (none for layer 0's z, a constant);
    replicated_w2 the sum of A x and the backward's sum for u; both the
    loss's sum, the clip norm's, and over the data group one sum a layer."""
    D = shape[0]
    per_layer = 5 + (D > 1) if layout == "sharded_w2" else 2 + (D > 1)
    fixed = 1 if layout == "sharded_w2" else 2
    assert runs[(*shape, layout)]["collectives"] == per_layer * K + fixed


def test_fit_sharded_tp_end_to_end_with_resume(runs):
    """fit_sharded on the 2x2 mesh (smoke, deep supervision): finite evals
    at steps 4 and 8 with the LADMM curve beside, the loss falling; a run
    cut at step 4 and resumed ends bit for bit on the cold run."""
    fit = runs["fit"]
    assert [h["step"] for h in fit["hist"]] == [4, 8] and [h["step"] for h in fit["hist2"]] == [8]
    assert all(h["mesh"] == "2x2" and np.isfinite(h["nmse_db"]) for h in fit["hist"])
    assert len(fit["curves"]["ladmm_curve_db"]) == 4 and fit["hist"][-1]["loss"] < fit["hist"][0]["loss"]
    for a, b in zip(fit["warm"], fit["cold"]):
        assert torch.equal(a, b)
    assert fit["hist2"][-1]["nmse_db"] == fit["hist"][-1]["nmse_db"]


def test_tp_checkpoint_served_by_the_single_device_server(runs, capsys, monkeypatch):
    """The TP run's checkpoint holds the whole params and A: serve
    --ckpt-dir on one device serves its eval batch at the last eval's
    NMSE (within 0.01 dB)."""
    from dladmm_tpu_torch import serve as tserve

    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    fit = runs["fit"]
    ckpt = torch.load(os.path.join(fit["ckpt"], "step_8.pt"), weights_only=True)
    assert tuple(ckpt["params"]["W1"].shape) == (4, 64, 32)
    for a, b in zip(fit["cold"], (ckpt["params"][f] for f in ("W1", "W2", "theta1", "theta2", "beta"))):
        assert torch.equal(a, b)
    assert tserve.main(["--config=smoke", "--ckpt-dir", fit["ckpt"], "--demo", "64"]) == 0
    served = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert served["nmse_db"] == pytest.approx(fit["hist"][-1]["nmse_db"], abs=0.01)


def test_init_params_tp_is_the_whole_init_sliced(prob):
    """init_params_tp on a 1x1 mesh is init_dladmm_params bit for bit."""
    from dladmm_tpu_torch.models.unroll import init_dladmm_params
    from dladmm_tpu_torch.parallel.collectives import init_params_tp
    from dladmm_tpu_torch.parallel.mesh import make_mesh

    A = torch.as_tensor(prob["A"])
    for layout in LAYOUTS:
        got = init_params_tp(A, K, make_mesh(data=1, devices=["cpu"]), layout)
        assert all(torch.equal(a, b) for a, b in zip(got, init_dladmm_params(A, K=K)))


def _tp_cfg(**train):
    from dladmm_tpu_torch.utils.config import Config, ProblemConfig, ShardingConfig, TrainConfig

    sharding = train.pop("sharding", {})
    problem = train.pop("problem", {})
    return Config(name="tp", problem=ProblemConfig(**{"m": M, "n": N, "K": 4, **problem}),
                  train=TrainConfig(batch=16, steps=2, **train),
                  sharding=ShardingConfig(data_axis=2, model_axis=2, **sharding))


REFUSALS = {
    "general_b": (dict(problem=dict(identity_B=False, d=20)), "general-B configs shard over 'data' only"),
    "fused_adam": (dict(optimizer="fused_adam", clip_mode="delayed"), "optimizer='fused_adam' shards over 'data'"),
    "zero1": (dict(sharding=dict(zero1=True)), "zero1 (cross-replica weight-update sharding)"),
    "kernel": (dict(kernel="megakernel"), "['kernel'] have no effect with model_axis=2"),
    "vjp": (dict(vjp="manual"), "['vjp'] have no effect with model_axis=2"),
    "int8": (dict(moment_dtype="int8"), "moment_dtype='int8' does not compose"),
    "pallas": (dict(moment_dtype="float32_pallas"), "moment_dtype='float32_pallas' does not compose"),
    "width": (dict(problem=dict(n=63)), "n=63 does not split over model_axis=2"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_check_sharded_refuses_as_jax_does(name):
    """The JAX package's refusals for model_axis > 1, in its order (a
    general B before the fused optimizer, zero1, kernel/vjp and the int8 /
    fused-sweep moments), and widths that do not split."""
    from dladmm_tpu_torch.train.loop import check_sharded

    kw, says = REFUSALS[name]
    with pytest.raises(ValueError) as err:
        check_sharded(_tp_cfg(**kw))
    assert says in str(err.value)


def test_check_sharded_refuses_in_jax_order():
    """The first failing condition decides, in the JAX package's order: a
    general B with a kernel is refused for the B, the fused optimizer with
    zero1 for the fused optimizer, zero1 with int8 moments for zero1."""
    from dladmm_tpu_torch.train.loop import check_sharded

    for kw, first in ((dict(kernel="megakernel", problem=dict(identity_B=False, d=20)), "general_b"),
                      (dict(optimizer="fused_adam", clip_mode="delayed", sharding=dict(zero1=True)), "fused_adam"),
                      (dict(moment_dtype="int8", sharding=dict(zero1=True)), "zero1")):
        with pytest.raises(ValueError) as err:
            check_sharded(_tp_cfg(**kw))
        assert REFUSALS[first][1] in str(err.value)


def test_check_sharded_lets_tp_compose():
    """bf16 compute, deep supervision, freeze, clipping and the fp32, bf16
    and bfloat16_sr moments pass (tp_small, tp_large, tp_large_bf16
    too)."""
    from dladmm_tpu_torch.train.loop import check_sharded
    from dladmm_tpu_torch.utils.config import get_config

    for md in ("float32", "bfloat16", "bfloat16_sr"):
        check_sharded(_tp_cfg(moment_dtype=md, compute_dtype="bfloat16", layer_loss="uniform", freeze=("beta",),
                              clip_norm=1.0))
    for name in ("tp_small", "tp_large", "tp_large_bf16"):
        check_sharded(get_config(name))


@pytest.mark.parametrize("extra,says", [
    (["--config=tp_small", "--zero1"], "--zero1 applies to DP-only sharded configs"),
    (["--config=tp_small", "--greedy"], "--greedy is single-device only"),
    (["--config=tp_small", "--export-torch=x.pt"], "--export-torch is single-device only"),
    (["--config=tp_small", "--import-torch=x.pt"], "--import-torch warm-starts the single-device fit only"),
    (["--config=tp_small", "--moment-dtype=int8_pallas"], "does not compose with model_axis=2"),
    (["--config=tp_large"], "--nproc_per_node=4 -m dladmm_tpu_torch.run --config=tp_large"),
    (["--config=tp_large_bf16"], "--nproc_per_node=8 -m dladmm_tpu_torch.run --config=tp_large_bf16"),
])
def test_run_cli_tp_refusals(extra, says, monkeypatch, capsys):
    """run.py's refusals for the TP presets: the JAX CLI's (--zero1,
    --greedy, --export-torch, --import-torch for sharded configs), the
    config's (check_sharded), and the launch line in one process."""
    from dladmm_tpu_torch import run as trun

    monkeypatch.setenv("DLADMM_PLATFORM", "cpu")
    with pytest.raises(SystemExit):
        trun.main(["--steps=1", *extra])
    assert says in capsys.readouterr().err


@pytest.mark.parametrize("layout,fits", [("sharded_w2", True), ("replicated_w2", False)])
def test_tp_large_audit_against_one_ranks_share_of_the_card(layout, fits):
    """sharded_audit passes the model axis: tp_large fits one rank's
    share of an 80 GB card shared by its 4 ranks with sharded_w2 (about
    13.2 GB) and is refused with replicated_w2 (the JAX test's trade)."""
    from dladmm_tpu_torch.train.loop import sharded_audit
    from dladmm_tpu_torch.utils.config import get_config

    cfg = get_config("tp_large")
    cfg = dataclasses.replace(cfg, sharding=dataclasses.replace(cfg.sharding, layout=layout))
    if fits:
        bd = sharded_audit(cfg, 80e9 / 4)
        assert 13.0e9 < bd.total < 13.4e9
    else:
        with pytest.raises(MemoryError, match="exceeds"):
            sharded_audit(cfg, 80e9 / 4)


def test_host_local_batch_keys_by_data_index(runs, prob):
    """Under TP each data index draws its own rows and its model ranks
    the same ones, each keeping its n-slice of x*; b is formed from the
    ranks' columns of A (their partial products summed): b = A x* + e*
    on the whole rows, to rounding."""
    parts = runs["host_local"]  # rank r's (b, x_star, e_star) on the 2x2 mesh
    A = torch.as_tensor(prob["A"])
    assert torch.equal(parts[0][0], parts[1][0]) and not torch.equal(parts[0][0], parts[2][0])
    assert torch.equal(parts[0][2], parts[1][2]) and parts[0][1].shape == (8, N // 2)
    for d in (0, 2):
        x = torch.cat([parts[d][1], parts[d + 1][1]], 1)
        torch.testing.assert_close(parts[d][0], x @ A.T + parts[d][2])


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2])
