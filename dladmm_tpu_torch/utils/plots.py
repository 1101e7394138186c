"""The NMSE-vs-layer figure (the paper's signature plot), a copy of
``dladmm_tpu/utils/plots.py``. matplotlib is imported when a plot is
drawn, so the package imports without it."""

from __future__ import annotations

from typing import Optional, Sequence


def save_nmse_curve_plot(
    path: str,
    dladmm_curve_db: Sequence[float],
    ladmm_curve_db: Optional[Sequence[float]] = None,
    title: str = "NMSE vs layer/iteration",
) -> str:
    """Write the learned net's per-layer NMSE (dB), and classical LADMM's
    where given, as a PNG at ``path``; returns ``path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    k = range(1, len(dladmm_curve_db) + 1)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(k, dladmm_curve_db, "o-", label="D-LADMM (learned)")
    if ladmm_curve_db is not None:
        ax.plot(range(1, len(ladmm_curve_db) + 1), ladmm_curve_db, "s--", label="LADMM (classical)")
    ax.set_xlabel("layer k / iteration")
    ax.set_ylabel("NMSE (dB)")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


__all__ = ["save_nmse_curve_plot"]
