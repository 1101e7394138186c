"""Port parity for the checkpoint bridge: the port's own copy of
utils/torch_compat.py reads every state-dict layout the JAX package's
reads, to the same parameters (the same key grammar, aliases,
transposition fix, beta rules and allow_pickle rule), and exports the
same state dict."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dladmm_tpu.models.unroll import init_dladmm_params as j_init
from dladmm_tpu.utils import torch_compat as jtc
from dladmm_tpu_torch.utils import torch_compat as ttc

M, N, K = 24, 40, 4


def _jax_params(seed=0, per_coordinate=True):
    rng = np.random.default_rng(seed)
    A = (rng.normal(size=(M, N)) / np.sqrt(M)).astype(np.float32)
    p = j_init(jnp.asarray(A), K=K, beta=0.7, per_coordinate=per_coordinate)
    leaves = [np.asarray(v) * rng.uniform(0.8, 1.2, size=v.shape) for v in p]
    return A, type(p)(*(jnp.asarray(v, jnp.float32) for v in leaves))


def _same(port, jax_params):
    for name, g, w in zip(jax_params._fields, port, jax_params):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def _relayout(sd, fmt, alias=None):
    out = {}
    for key, v in sd.items():
        f, k = key.split(".")
        out[fmt.format(f=(alias or {}).get(f, f), k=k)] = v
    return out


@pytest.mark.parametrize(
    "layout",
    ["param_list", "underscore", "module_list", "aliases", "scalar_theta",
     "vector_beta", "transposed_w1", "file"],
)
def test_from_torch_matches_jax(layout, tmp_path):
    A, params = _jax_params(seed=len(layout), per_coordinate=layout != "scalar_theta")
    sd = jtc.to_torch_state_dict(params)
    kw = {}
    if layout == "underscore":
        sd = _relayout(sd, "{f}_{k}")
    elif layout == "module_list":
        sd = _relayout(sd, "net.layers.{k}.{f}")
    elif layout == "aliases":
        sd = _relayout(sd, "{f}.{k}", {"theta1": "soft_thr1", "theta2": "soft_thr2", "beta": "rho"})
        sd["A"] = torch.zeros(M, N)  # not a parameter: ignored with a warning
    elif layout == "vector_beta":
        sd["beta"] = torch.stack([sd.pop(f"beta.{k}") for k in range(K)])
    elif layout == "transposed_w1":
        for k in range(K):
            sd[f"W1.{k}"] = sd[f"W1.{k}"].T.contiguous()
        kw["A"] = A
    source = sd
    if layout == "file":
        source = tmp_path / "net.pt"
        ttc.save_torch(ttc.from_torch(sd), source)
        source = str(source)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jtc.from_torch(source, **kw)
        got = ttc.from_torch(source, **kw)
    _same(got, want)


def test_missing_beta_and_errors_match_jax():
    _, params = _jax_params(1)
    sd = jtc.to_torch_state_dict(params)
    for k in range(K):
        del sd[f"beta.{k}"]
    with pytest.warns(UserWarning, match="no beta"):
        got = ttc.from_torch(sd, default_beta=0.3)
    with pytest.warns(UserWarning, match="no beta"):
        want = jtc.from_torch(sd, default_beta=0.3)
    _same(got, want)
    bad = {k.replace("W1", "mystery"): v for k, v in jtc.to_torch_state_dict(params).items()}
    with pytest.raises(ValueError, match="rename="):
        ttc.from_torch(bad)
    renamed = ttc.from_torch(bad, rename={f"mystery.{k}": f"W1.{k}" for k in range(K)})
    _same(renamed, params)


def test_export_matches_jax_and_round_trips():
    _, params = _jax_params(2)
    port = ttc.params_from_numpy(*(np.asarray(v) for v in params))
    want = jtc.to_torch_state_dict(params)
    got = ttc.to_torch_state_dict(port)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == torch.float32 and got[key].device.type == "cpu"
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    _same(ttc.from_torch(got), params)


class _Box:  # module-level so torch.save can pickle it
    """Stand-in for a torch.save(net) whole-module checkpoint."""

    def __init__(self, sd):
        self._sd = sd

    def state_dict(self):
        return self._sd


def test_module_pickle_needs_opt_in(tmp_path):
    _, params = _jax_params(3)
    path = tmp_path / "whole.pt"
    torch.save(_Box(jtc.to_torch_state_dict(params)), path)
    with pytest.raises(ValueError, match="allow_pickle"):
        ttc.from_torch(str(path))
    _same(ttc.from_torch(str(path), allow_pickle=True), params)
