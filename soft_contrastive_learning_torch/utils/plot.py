"""Plot helpers. Own copy of ``soft_contrastive_learning_tpu/utils/plot.py``;
matplotlib is imported when a figure is drawn, and its absence raises with
the reason (the card's machine has none)."""

from __future__ import annotations

from typing import Dict


def dict_to_bar(data: Dict[str, float], out_file: str) -> None:
    """Bar chart of a dict saved to a file."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(f"drawing {out_file} needs matplotlib, which is not installed") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(7, 7))
    names = list(data.keys())
    values = list(data.values())
    plt.bar(range(len(data)), values, tick_label=names)
    plt.xticks(rotation=45)
    plt.savefig(out_file)
    plt.close(fig)
