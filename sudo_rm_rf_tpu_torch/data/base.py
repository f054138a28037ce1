"""Audio file reading (counterpart of ``sudo_rm_rf_tpu/data/base.py::read_wav``).

Kept in the port so that serving imports only numpy and scipy: the JAX
package's ``data`` subpackage pulls in its dataset loaders and their
dependencies when imported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[int, np.ndarray]:
    """Read a wav file to float32 (int PCM scaled by dtype max; float wavs
    passed through)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return sr, data
