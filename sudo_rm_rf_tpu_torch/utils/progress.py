"""Progress display (counterpart of ``sudo_rm_rf_tpu/utils/progress.py``):
a map with a progress bar, through tqdm where it is importable, else a
plain loop that prints the message once."""

from __future__ import annotations

from typing import Callable, List, Sequence


def progress_bar_wrapper(func: Callable, items: Sequence, message: str = "") -> List:
    """``[func(x) for x in items]``, shown as a bar labelled ``message``."""
    try:
        from tqdm import tqdm

        iterator = tqdm(items, desc=message or None)
    except Exception:
        if message:
            print(message)
        iterator = items
    return [func(x) for x in iterator]
