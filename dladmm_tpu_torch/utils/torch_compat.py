"""PyTorch checkpoint migration: reference-style weights <-> DLADMMParams.

The port's own copy of ``dladmm_tpu/utils/torch_compat.py``, with the
same key grammar, aliases, transposition fix and ``allow_pickle`` rule;
it returns the port's stacked ``[K, ...]`` tensors on a chosen device.

The reference implementation (SURVEY.md §3.1 "Model" row) is a PyTorch
``nn.Module`` holding K layers of ``nn.Parameter``s (W1_k, W2_k, theta1_k,
theta2_k, beta_k). A user switching from the reference arrives with
``torch.save``d checkpoints of that module; this module imports them into
the stacked ``[K, ...]`` parameters the unroll consumes
(models/unroll.py), and exports back for anyone round-tripping.
``params_from_numpy`` carries parameters that arrive as numpy arrays
(for example the JAX package's) into the port, ``opt_state_from_numpy``
the JAX package's fused-optimizer state (int8 or dense moments),
``quantized_from_numpy`` its int8 serving operands.

Because the reference mount was empty during the survey (SURVEY.md §0),
the exact parameter names are unknown; the importer therefore accepts the
common PyTorch layouts for per-layer parameter families —

  * ``nn.ParameterList`` keys:        ``W1.0, W1.1, ...``
  * underscore-indexed attributes:    ``W1_0, W1_1, ...``
  * ``nn.ModuleList`` of layer blocks: ``layers.0.W1, layers.1.W1, ...``

— under a set of name aliases per parameter family (``theta1`` vs
``soft_thr1`` etc.), and fails with the full list of unmatched keys when
a checkpoint uses names it cannot classify (pass ``rename=`` to map them).

Orientation: the reference stores W1 as the (n, m) matrix multiplying the
m-vector residual (SURVEY.md §2 layer equations) — the same convention as
ours — but ``nn.Linear``-based variants store the transpose. When the
dictionary ``A`` is supplied, a transposed W1/W2 is detected from the
shapes and fixed with a warning.
"""

from __future__ import annotations

import re
import warnings
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from dladmm_tpu_torch.models.unroll import DLADMMParams

# Lowercase alias -> canonical family name. Matched against the final
# name token of each checkpoint key (index digits stripped).
_ALIASES: Dict[str, str] = {
    "w1": "W1",
    "w_1": "W1",
    "w2": "W2",
    "w_2": "W2",
    "theta1": "theta1",
    "theta_1": "theta1",
    "th1": "theta1",
    "thr1": "theta1",
    "soft_thr1": "theta1",
    "eta1": "theta1",
    "theta2": "theta2",
    "theta_2": "theta2",
    "th2": "theta2",
    "thr2": "theta2",
    "soft_thr2": "theta2",
    "eta2": "theta2",
    "beta": "beta",
    "rho": "beta",
    "bt": "beta",
}

_FAMILIES = ("W1", "W2", "theta1", "theta2", "beta")

# key -> (family, layer index). Handles "W1.3", "W1_3", "layers.3.W1",
# "net.layers.3.soft_thr1" — the layer index is the LAST integer token.
_TOKEN_RE = re.compile(r"[._]")


def _classify_key(key: str) -> Optional[tuple]:
    tokens = [t for t in _TOKEN_RE.split(key) if t]
    if not tokens:
        return None
    idxs = [i for i, t in enumerate(tokens) if t.isdigit()]
    # The name token is the last non-integer token; allow a trailing
    # index ("W1.3") or a leading block index ("layers.3.W1").
    name_tokens = [t for t in tokens if not t.isdigit()]
    if not name_tokens:
        return None
    name = name_tokens[-1].lower()
    # underscore-indexed attribute: "W1_3" arrives as tokens [W1, 3]
    # already split; "soft_thr1" keeps its trailing digit as part of the
    # alias, so only strip digits NOT consumed by an alias match.
    family = _ALIASES.get(name)
    if family is None:
        stripped = name.rstrip("0123456789")
        trailing = name[len(stripped):]
        if stripped and _ALIASES.get(stripped) and trailing:
            family = _ALIASES[stripped]
            return family, int(trailing)
        return None
    if not idxs:
        return family, 0
    return family, int(tokens[idxs[-1]])


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        try:
            v = v.numpy()
        except TypeError:
            # bfloat16 tensors have no numpy dtype; we upcast to f64
            # below anyway, so a float32 hop loses nothing.
            v = v.float().numpy()
    return np.asarray(v, dtype=np.float64)


def _unwrap(source, allow_pickle: bool = False) -> Mapping[str, object]:
    """Path / nn.Module / mapping -> flat state-dict-like mapping."""
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        try:
            source = torch.load(source, map_location="cpu", weights_only=True)
        except Exception as e:
            # Checkpoints of whole modules (torch.save(net)) need a full
            # unpickle; weights_only rejects them. A full unpickle
            # executes arbitrary code from the file, so it must be an
            # explicit opt-in — never a silent fallback, which would
            # re-enable exactly what the safe loader refused.
            if not allow_pickle:
                raise ValueError(
                    "torch.load(weights_only=True) rejected this "
                    "checkpoint. If it is a trusted torch.save(net) "
                    "whole-module file, retry with allow_pickle=True "
                    "(executes pickle code from the file)."
                ) from e
            source = torch.load(source, map_location="cpu", weights_only=False)
    if hasattr(source, "state_dict") and not isinstance(source, Mapping):
        source = source.state_dict()
    if isinstance(source, Mapping) and "state_dict" in source and isinstance(
        source["state_dict"], Mapping
    ):
        source = source["state_dict"]
    if not isinstance(source, Mapping):
        raise TypeError(
            f"cannot interpret {type(source).__name__} as a torch state dict"
        )
    return source


def from_torch(
    source,
    A: Optional[np.ndarray] = None,
    rename: Optional[Mapping[str, str]] = None,
    default_beta: float = 1.0,
    dtype=torch.float32,
    allow_pickle: bool = False,
    device=None,
) -> DLADMMParams:
    """Import reference-style PyTorch weights into stacked DLADMMParams.

    Args:
      source: a ``torch.save`` checkpoint path, an ``nn.Module``, or a
        state-dict mapping (raw, or wrapped under a ``"state_dict"`` key).
      A: optional (m, n) dictionary (numpy array or tensor) used only to
        detect and fix transposed W1/W2 (nn.Linear orientation); pass it
        when available.
      rename: optional {checkpoint key -> canonical key} applied before
        classification, for checkpoints whose names no alias covers.
      default_beta: per-layer beta to synthesize when the checkpoint has
        none (some reference variants fix beta rather than learn it —
        SURVEY.md §10 Q4).
      dtype: dtype of the returned leaves.
      allow_pickle: permit a full (arbitrary-code-executing) unpickle
        for ``torch.save(net)`` whole-module checkpoints that the safe
        ``weights_only`` loader rejects. Only set for trusted files.
      device: device of the returned leaves (CPU when None).

    Returns:
      DLADMMParams with leading K axis on every leaf, ready for
      models/unroll.dladmm_forward and the serving path.
    """
    sd = _unwrap(source, allow_pickle=allow_pickle)
    if rename:
        sd = {rename.get(k, k): v for k, v in sd.items()}

    groups: Dict[str, Dict[int, np.ndarray]] = {f: {} for f in _FAMILIES}
    unmatched = []
    for key, val in sd.items():
        hit = _classify_key(str(key))
        if hit is None:
            unmatched.append(str(key))
            continue
        family, idx = hit
        if idx in groups[family]:
            raise ValueError(
                f"duplicate entry for {family} layer {idx} "
                f"(key {key!r}) — pass rename= to disambiguate"
            )
        groups[family][idx] = _to_numpy(val)

    missing = [f for f in ("W1", "W2", "theta1", "theta2") if not groups[f]]
    if missing:
        raise ValueError(
            f"checkpoint has no keys for {missing}; unmatched keys were "
            f"{sorted(unmatched)} — pass rename= mapping them to "
            f"'<family>.<layer>' (families: {list(_FAMILIES)})"
        )
    if unmatched:
        warnings.warn(
            f"ignored {len(unmatched)} non-parameter checkpoint keys: "
            f"{sorted(unmatched)[:8]}{'...' if len(unmatched) > 8 else ''}"
        )

    K = len(groups["W1"])
    for f in ("W1", "W2", "theta1", "theta2"):
        idxs = sorted(groups[f])
        if idxs != list(range(K)):
            raise ValueError(
                f"{f} layer indices {idxs} are not contiguous 0..{K - 1}"
            )
    if groups["beta"]:
        only = groups["beta"].get(0)
        if (
            len(groups["beta"]) == 1
            and only is not None
            and only.size == K
            and K > 1
        ):
            # Single (K,) vector parameter holding all layers' betas.
            groups["beta"] = {k: only.reshape(-1)[k] for k in range(K)}
        if sorted(groups["beta"]) != list(range(K)):
            raise ValueError(
                f"beta layer indices {sorted(groups['beta'])} do not match "
                f"K={K} layers"
            )
        beta = np.stack(
            [groups["beta"][k].reshape(()) for k in range(K)]
        )
    else:
        warnings.warn(
            f"checkpoint has no beta parameters; filling beta={default_beta}"
        )
        beta = np.full((K,), default_beta)

    stack = lambda f: np.stack([groups[f][k] for k in range(K)])
    W1, W2 = stack("W1"), stack("W2")

    if A is not None:
        m, n = tuple(A.shape)
        if m != n:
            if W1.shape[1:] == (m, n):
                warnings.warn(
                    f"W1 arrived transposed ({(m, n)}, nn.Linear "
                    f"orientation); storing as (n, m)=({n}, {m})"
                )
                W1 = np.swapaxes(W1, 1, 2)
            elif W1.shape[1:] != (n, m):
                raise ValueError(
                    f"W1 per-layer shape {W1.shape[1:]} matches neither "
                    f"(n, m)=({n}, {m}) nor its transpose for A {(m, n)}"
                )
        if W2.shape[1] != W2.shape[2] and W2.shape[2] != m:
            if W2.shape[1] == m:
                warnings.warn(
                    "W2 arrived transposed (nn.Linear orientation); "
                    "storing as (d, m)"
                )
                W2 = np.swapaxes(W2, 1, 2)
            else:
                raise ValueError(
                    f"W2 per-layer shape {W2.shape[1:]} has no axis of "
                    f"size m={m}"
                )

    def norm_theta(t: np.ndarray) -> np.ndarray:
        # scalars -> (K, 1); (K, 1, n) row vectors -> (K, n)
        t = t.reshape(t.shape[0], -1) if t.ndim > 1 else t[:, None]
        return t

    return params_from_numpy(
        W1, W2, norm_theta(stack("theta1")), norm_theta(stack("theta2")),
        beta.reshape(-1), device=device, dtype=dtype,
    )


def params_from_numpy(
    W1, W2, theta1, theta2, beta, device=None, dtype=torch.float32
) -> DLADMMParams:
    """Stacked parameters given as numpy arrays (e.g. the JAX package's
    DLADMMParams leaves through ``np.asarray``) -> the port's
    DLADMMParams: contiguous ``dtype`` tensors on ``device`` (CPU when
    None), shapes unchanged."""
    return DLADMMParams(
        *(
            torch.as_tensor(np.array(a), dtype=dtype, device=device)
            for a in (W1, W2, theta1, theta2, beta)
        )
    )


def quantized_from_numpy(qp, qd, device=None):
    """The JAX package's int8 serving operands (``QuantizedParams`` and
    ``QuantizedDict`` of ops/quantized.py, anything with those fields)
    -> the port's, on ``device``: int8 codes and fp32 scales, thresholds
    and beta, shapes unchanged. Everything goes through ``np.asarray``."""
    from dladmm_tpu_torch.ops.quantized import QuantizedDict, QuantizedParams

    def put(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    codes = ("W1_q", "W2_q")
    return (
        QuantizedParams(*(put(getattr(qp, f), torch.int8 if f in codes else torch.float32)
                          for f in QuantizedParams._fields)),
        QuantizedDict(put(qd.A_q, torch.int8), put(qd.A_s, torch.float32)),
    )


def _dense_from_numpy(a, device=None) -> torch.Tensor:
    """One dense moment leaf (fp32, or bf16 as numpy's ml_dtypes
    bfloat16, which torch cannot read directly) -> a tensor of the same
    dtype, bit for bit."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.view(np.int16), device=device).view(torch.bfloat16)
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def opt_state_from_numpy(state, device=None):
    """The JAX package's fused-optimizer state (``QMomentsState`` of
    ``QAdamFusedPallas``, any object with ``count``, ``mu`` and ``nu``)
    -> the port's train/qadam_cuda state on ``device``.

    Int8 moment leaves (with ``codes`` and ``scale``): flat-256 leaves
    keep their (nblocks, 256) codes and (nblocks,) scales; per-row
    leaves arrive with the TPU's lane-packed (ceil(R/128), 128) scales
    and leave with (R,) scales, the packing's padding rows dropped.
    Dense moment leaves (the float32, bfloat16 and SR formats) keep
    their shape and dtype. Everything goes through ``np.asarray``, so
    the arrays may be the JAX package's."""
    from dladmm_tpu_torch.train.qmoments import QMomentsState, QTensor

    def leaf(q):
        if not hasattr(q, "codes"):
            return _dense_from_numpy(q, device)
        codes = np.array(q.codes)
        scale = np.array(q.scale, dtype=np.float32)
        if scale.ndim == 2:  # lane-packed per-row scales
            scale = scale.reshape(-1)[: codes.shape[0]]
        return QTensor(
            torch.as_tensor(codes, dtype=torch.int8, device=device),
            torch.as_tensor(scale, device=device),
        )

    return QMomentsState(
        count=torch.as_tensor(np.array(state.count), dtype=torch.int32, device=device),
        mu=DLADMMParams(*(leaf(q) for q in state.mu)),
        nu=DLADMMParams(*(leaf(q) for q in state.nu)),
    )


def to_torch_state_dict(params: DLADMMParams) -> Dict[str, torch.Tensor]:
    """Export stacked params as a ParameterList-style torch state dict.

    Keys are ``W1.{k}`` / ``W2.{k}`` / ``theta1.{k}`` / ``theta2.{k}`` /
    ``beta.{k}`` — the layout ``from_torch`` (and a reference-style
    ``nn.ParameterList`` module) accepts. Values are float32 CPU tensors.
    """
    out: Dict[str, torch.Tensor] = {}
    for family in _FAMILIES:
        stacked = getattr(params, family).detach().to("cpu", torch.float32)
        for k in range(stacked.shape[0]):
            out[f"{family}.{k}"] = stacked[k].clone()
    return out


def save_torch(params: DLADMMParams, path) -> None:
    """torch.save the ParameterList-style export of ``params``."""
    torch.save(to_torch_state_dict(params), path)


__all__ = [
    "from_torch",
    "opt_state_from_numpy",
    "params_from_numpy",
    "quantized_from_numpy",
    "save_torch",
    "to_torch_state_dict",
]
