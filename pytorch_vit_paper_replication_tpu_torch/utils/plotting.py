"""Loss-curve plotting — equivalent of helper_functions ``plot_loss_curves``
(reference main notebook cells 101-102, 127).

Takes the results dict that :func:`..engine.train` returns (same shape as the
reference's, engine.py:173) and renders loss + accuracy curves. Matplotlib is
imported lazily and the function degrades to a no-op with a warning when it
is unavailable or headless saving is requested without a path.
"""

from __future__ import annotations

from typing import Dict, Optional


def plot_loss_curves(results: Dict[str, list],
                     save_path: Optional[str] = None):
    """Plot train/test loss and accuracy vs epoch.

    Returns the matplotlib figure, or None if matplotlib is missing.
    """
    try:
        import matplotlib
        if save_path is not None:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # matplotlib not installed
        print("[warn] matplotlib unavailable; skipping plot")
        return None

    epochs = range(1, len(results["train_loss"]) + 1)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4.5))
    ax1.plot(epochs, results["train_loss"], label="train_loss")
    ax1.plot(epochs, results["test_loss"], label="test_loss")
    ax1.set_title("Loss"); ax1.set_xlabel("Epochs"); ax1.legend()
    ax2.plot(epochs, results["train_acc"], label="train_accuracy")
    ax2.plot(epochs, results["test_acc"], label="test_accuracy")
    ax2.set_title("Accuracy"); ax2.set_xlabel("Epochs"); ax2.legend()
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=120)
    return fig
