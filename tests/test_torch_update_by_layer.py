"""The single-card fp32 Adam step updates its state in place where the
whole-leaf update would not fit in the memory left
(train/loop._whole_update_fits): adam()'s chain in one sweep over every
leaf (train/loop._adam_in_place, train/qadam_cuda.adam_inplace, whose
plain version runs here). The tensor-parallel step's routine
(train/loop.update_by_layer) updates one layer at a time. Both give the
values of the whole-leaf functional update bit for bit. Where it fits,
with reduced-precision moments and for other chains, the functional
update stays. On the CPU at K = 3 with stacked leaves; the in-place
branch is taken by reporting no free memory."""

import pytest
import torch

from dladmm_tpu_torch.data.synthetic import make_batch, step_generator
from dladmm_tpu_torch.models.unroll import DLADMMParams, init_dladmm_params
from dladmm_tpu_torch.train import loop, qadam_cuda
from dladmm_tpu_torch.train.qmoments import adam_qmoments

M, N, K, S, SEED = 24, 48, 3, 16, 7


def _problem():
    g = torch.Generator().manual_seed(3)
    A = torch.randn((M, N), generator=g)
    A = A / torch.linalg.vector_norm(A, dim=0, keepdim=True)
    params = init_dladmm_params(A, K=K)
    params = DLADMMParams(*(p + 0.05 * p.abs().mean() * torch.randn(p.shape, generator=g) for p in params))
    return A, params


def _optimizer(clip, lr=2e-3):
    opt = loop.adam(lr)
    if clip == "global":
        return loop.chain(loop.clip_by_global_norm(1e-3), opt)  # small: the clip acts every step
    if clip == "delayed":
        return loop.chain(loop.delayed_clip_by_global_norm(1e-3), opt)
    return opt


def _functional_step(optimizer, A, freeze):
    """The whole-leaf update as a function of the state: the optimizer's
    chain over the stacked leaves, new tensors for everything."""
    def step(state, i):
        data = make_batch(step_generator(SEED, i), A, S, 0.1, 0.1, A.dtype)
        loss, grads = loop._value_and_grad(state.params, (A, data.b, data.x_star, data.e_star, None, None),
                                           {"step_fn": None, "forward_fn": None, "vjp": "auto"})
        grads = DLADMMParams(*(torch.zeros_like(g) if f in freeze else g for f, g in zip(grads._fields, grads)))
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
            params = loop.apply_updates(state.params, updates)
        return loop.TrainState(params, opt_state, state.step + 1), loss

    return step


def _tensors(tree):
    out = []
    loop.zip_nodes(tree, tree, lambda a, _: out.extend(a), lambda a, _: out.append(a) if torch.is_tensor(a) else None)
    return out


@pytest.fixture
def no_free_memory(monkeypatch):
    """The device's memory and the memory left read 0 bytes, so fp32 Adam
    takes the in-place branch."""
    monkeypatch.setattr(loop, "_total_bytes", lambda device: 0)
    monkeypatch.setattr(loop, "_free_bytes", lambda device: 0)


@pytest.fixture
def calls(monkeypatch):
    """Calls of the in-place routes, counted: the sweep (loop.adam_inplace),
    its plain version and update_by_layer."""
    seen = {"sweep": 0, "plain": 0, "by_layer": 0}

    def spy(name, fn):
        def counted(*args, **kw):
            seen[name] += 1
            return fn(*args, **kw)

        return counted

    monkeypatch.setattr(loop, "adam_inplace", spy("sweep", loop.adam_inplace))
    monkeypatch.setattr(qadam_cuda, "adam_inplace_plain", spy("plain", qadam_cuda.adam_inplace_plain))
    monkeypatch.setattr(loop, "update_by_layer", spy("by_layer", loop.update_by_layer))
    return seen


@pytest.mark.parametrize("freeze", [(), ("W2",)])
@pytest.mark.parametrize("clip", [None, "global", "delayed"])
def test_fp32_adam_in_place_equals_the_functional_update_bit_for_bit(clip, freeze, no_free_memory, calls):
    _equals_the_functional_update(clip, freeze)
    assert calls == {"sweep": 3, "plain": 3, "by_layer": 0}


@pytest.mark.parametrize("freeze", [(), ("W2",)])
@pytest.mark.parametrize("clip", [None, "global", "delayed"])
def test_update_by_layer_equals_the_functional_update_bit_for_bit(clip, freeze, no_free_memory, calls, monkeypatch):
    """The per-layer routine, which the tensor-parallel step takes, in
    place of the single-card step's optimizer step for adam()'s chain."""
    def by_layer(optimizer, state, grads, freeze=(), compute_dtype=None):
        with torch.no_grad():
            layers = [DLADMMParams(*(g[k] for g in grads)) for k in range(grads[0].shape[0])]
            return loop.update_by_layer(optimizer, state, layers, lambda: loop.global_norm(loop._frozen(grads, freeze)),
                                        freeze, compute_dtype)

    monkeypatch.setattr(loop, "_apply", by_layer)
    _equals_the_functional_update(clip, freeze)
    assert calls == {"sweep": 0, "plain": 0, "by_layer": 3}


def _equals_the_functional_update(clip, freeze):
    A, params = _problem()
    optimizer = _optimizer(clip)
    in_place = loop.make_train_step(optimizer, A, S, freeze=freeze, seed=SEED)
    functional = _functional_step(optimizer, A, freeze)
    a = loop.make_train_state(params, optimizer)
    b = loop.make_train_state(params, optimizer)
    for i in range(3):
        a, loss_a = in_place(a, i)
        b, loss_b = functional(b, i)
        assert torch.equal(loss_a, loss_b)
        for x, y in zip(_tensors((a.params, a.opt_state)), _tensors((b.params, b.opt_state))):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert a.step == b.step == 3
    if "W2" in freeze:
        assert torch.equal(a.params.W2, params.W2)


def _structure(tree):
    """The tree's node types, with each tensor's shape and type."""
    if torch.is_tensor(tree):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, tuple):
        return type(tree).__name__, tuple(_structure(v) for v in tree)
    return tree


@pytest.mark.parametrize("clip,schedule", [(None, False), ("global", False), ("delayed", True)])
def test_the_sweep_keeps_the_state_s_structure_storage_and_counts(clip, schedule, no_free_memory, calls):
    """Two steps through the sweep (its plain version here; with the
    warmup-cosine rate for the delayed clip): the chain's state tree and
    counts, the state's own storage, the whole-leaf update's values."""
    A, params = _problem()
    optimizer = _optimizer(clip, loop.warmup_cosine_decay_schedule(0.0, 2e-3, 1, 10) if schedule else 2e-3)
    state = loop.make_train_state(params, optimizer)
    want = loop.make_train_state(params, optimizer)
    before = _storage(state)
    step, functional = loop.make_train_step(optimizer, A, S, seed=SEED), _functional_step(optimizer, A, ())
    for i in range(2):
        state, _ = step(state, i)
        want, _ = functional(want, i)
    assert _storage(state) == before
    assert _structure(state.opt_state) == _structure(want.opt_state)
    adam, rate_count = state.opt_state if clip is None else state.opt_state[1]
    assert type(adam) is loop.AdamState and int(adam.count) == int(rate_count) == 2
    for x, y in zip(_tensors((state.params, state.opt_state)), _tensors((want.params, want.opt_state))):
        assert torch.equal(x, y)
    assert calls == {"sweep": 2, "plain": 2, "by_layer": 0}


@pytest.mark.parametrize("kind,fits,route", [
    ("adam", False, "sweep"), ("adam+global", False, "sweep"), ("adam", True, None),
    ("int8", False, None), ("bfloat16", False, None), ("float32_pallas", False, None),
    ("chain", False, None)])
def test_the_sweep_takes_only_fp32_adam_in_the_in_place_branch(kind, fits, route, monkeypatch, calls):
    """adam() alone or after a clip, in the in-place branch: the sweep. Where
    the update fits, with reduced-precision moments and with the fused
    sweep: their own paths. fp32 Adam chained by hand, without adam()'s
    hyperparameters: the whole-leaf update, never update_by_layer."""
    A, params = _problem()
    optimizer = {
        "adam": lambda: loop.adam(1e-3), "adam+global": lambda: _optimizer("global"),
        "int8": lambda: adam_qmoments(1e-3, moment_dtype="int8"),
        "bfloat16": lambda: adam_qmoments(1e-3, moment_dtype="bfloat16"),
        "float32_pallas": lambda: qadam_cuda.QAdamFused(1e-3, moment_fmt="float32"),
        "chain": lambda: loop.chain(loop.scale_by_adam(), loop.scale_by_learning_rate(1e-3)),
    }[kind]()
    memory = (1 << 40) if fits else 0
    monkeypatch.setattr(loop, "_total_bytes", lambda device: memory)
    monkeypatch.setattr(loop, "_free_bytes", lambda device: memory)
    loop.make_train_step(optimizer, A, S, seed=SEED)(loop.make_train_state(params, optimizer), 0)
    assert calls == {"sweep": int(route == "sweep"), "plain": int(route == "sweep"),
                     "by_layer": int(route == "by_layer")}


def test_fp32_adam_updates_the_state_s_own_storage(no_free_memory):
    A, params = _problem()
    optimizer = _optimizer("global")
    state = loop.make_train_state(params, optimizer)
    before = [t.data_ptr() for t in _tensors((state.params, state.opt_state)) if t.dim() > 0]
    step = loop.make_train_step(optimizer, A, S, seed=SEED)
    for i in range(2):
        state, _ = step(state, i)
    assert [t.data_ptr() for t in _tensors((state.params, state.opt_state)) if t.dim() > 0] == before
    assert int(state.opt_state[1][0].count) == 2


@pytest.mark.parametrize("moments,in_place", [
    ("float32", True), ("int8", False), ("bfloat16", False), ("bfloat16_sr", False)])
def test_only_moments_shaped_and_typed_as_the_params_update_by_layer(moments, in_place):
    A, params = _problem()
    optimizer = loop.adam(1e-3) if moments == "float32" else adam_qmoments(1e-3, moment_dtype=moments)
    state = loop.make_train_state(params, optimizer)
    grads = DLADMMParams(*(torch.ones_like(p) for p in params))
    assert loop._elementwise_state(state, grads) is in_place
    assert not loop._elementwise_state(state, DLADMMParams(*(g.to(torch.bfloat16) for g in grads)))


def _storage(state):
    return [t.data_ptr() for t in _tensors((state.params, state.opt_state)) if t.dim() > 0]


def test_fp32_adam_keeps_the_whole_leaf_update_where_it_fits():
    A, params = _problem()
    optimizer = _optimizer("global")
    state = loop.make_train_state(params, optimizer)
    assert loop._whole_update_fits(state)
    before = _storage(state)
    state, _ = loop.make_train_step(optimizer, A, S, seed=SEED)(state, 0)
    assert not set(_storage(state)) & set(before)


@pytest.mark.parametrize("copy,total,free,fits", [
    (False, 0, 0, False), (False, 0, 5 * 4000 - 1, False), (False, 0, 5 * 4000, True),
    (True, 0, 5 * 4000, False), (True, 0, 5 * 4000 + 2000, True),
    (False, 10 * 5 * 4000, 0, True), (False, 10 * 5 * 4000 - 10, 0, False), (True, 10 * 5 * 4000, 0, False)])
def test_the_whole_leaf_update_fits_in_five_times_the_params_bytes(monkeypatch, copy, total, free, fits):
    """1000 fp32 parameters (4000 bytes); a bf16 compute copy adds its
    2000. Within a tenth of the device's memory the memory left is not
    asked."""
    params = DLADMMParams(*(torch.zeros(n) for n in (600, 300, 50, 40, 10)))
    state = loop.make_train_state(params, loop.adam(1e-3))
    if copy:
        state = state._replace(compute_params=DLADMMParams(*(p.to(torch.bfloat16) for p in params)))
    monkeypatch.setattr(loop, "_total_bytes", lambda device: total)
    monkeypatch.setattr(loop, "_free_bytes", lambda device: free)
    assert loop._whole_update_fits(state) is fits


def test_the_host_reports_its_memory():
    assert loop._total_bytes(torch.device("cpu")) >= loop._free_bytes(torch.device("cpu")) > 0
