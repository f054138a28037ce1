"""Streaming (block-online) separation for the causal SuDoRM-RF
(counterpart of ``sudo_rm_rf_tpu/inference/streaming.py``).

Each step runs the model over one fixed window, [left context | new hop],
and emits only the samples of one hop. The causal model reads a bounded
lookahead (its unmasked transposed-conv decoder reaches enc_kernel_size//2
input samples ahead), so a step emits the hop that ends ``lookahead``
samples behind the newest input. Emitted samples never change once
produced, and with enough grid-aligned context the streamed output equals
the offline forward.

The window stays on the model's device (the JAX package rolls a host numpy
buffer; the samples emitted are the same), and each step runs under
``torch.inference_mode``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class StreamingSeparator:
    """Block-online separation with a rolling left-context window.

    Args:
      model: causal ``nn.Module`` (B, C, T) -> (B, S, T), on the device the
        steps run on.
      hop_samples: samples consumed and emitted per step.
      context_samples: left context before each hop; must cover the model's
        receptive field and be a multiple of its padding granule
        (enc_kernel_size//2 * 2**depth) so that the conv grids align.
      num_sources: S.
      lookahead_samples: output latency, >= enc_kernel_size//2; defaults to
        the model's padding granule (``n_least_samples_req``), else one hop.
    """

    def __init__(self, model, hop_samples: int, context_samples: int,
                 num_sources: int = 2, lookahead_samples: Optional[int] = None):
        self.hop = int(hop_samples)
        self.context = int(context_samples)
        self.num_sources = num_sources
        if lookahead_samples is None:
            granule = getattr(model, "n_least_samples_req", None)
            lookahead_samples = int(granule) if granule else self.hop
        self.lookahead = int(lookahead_samples)
        if self.lookahead > self.context:
            raise ValueError("lookahead must not exceed the context")
        self.model = model
        self.device = next(model.parameters()).device
        self._window = self.context + self.hop
        self.reset()

    def reset(self):
        self._buffer = torch.zeros((1, 1, self._window), device=self.device)

    @torch.inference_mode()
    def _step(self, hop_audio: torch.Tensor) -> torch.Tensor:
        self._buffer = torch.cat([self._buffer[..., self.hop:], hop_audio[None, None]], dim=-1)
        w, la = self._window, self.lookahead
        return self.model(self._buffer)[0, :, w - la - self.hop: w - la]

    def push(self, hop_audio) -> np.ndarray:
        """Feed exactly ``hop_samples`` new samples; returns the (S, hop)
        estimates of the span ending ``lookahead`` samples behind the newest
        input."""
        hop_audio = torch.as_tensor(np.asarray(hop_audio, np.float32).reshape(-1))
        if hop_audio.shape[0] != self.hop:
            raise ValueError(
                f"push expects exactly {self.hop} samples, got {hop_audio.shape[0]}")
        return self._step(hop_audio.to(self.device)).cpu().numpy()

    def separate_stream(self, mixture) -> np.ndarray:
        """Stream a whole recording hop by hop -> (S, T), flushing the
        latency with ceil(lookahead/hop) silent hops and realigning, so the
        result compares directly with the offline forward."""
        mixture = np.asarray(mixture, np.float32).reshape(-1)
        t = mixture.shape[0]
        n_hops = -(-t // self.hop)
        n_extra = -(-self.lookahead // self.hop)
        padded = np.zeros((n_hops + n_extra) * self.hop, np.float32)
        padded[:t] = mixture
        self.reset()
        outs = [self.push(padded[i * self.hop: (i + 1) * self.hop])
                for i in range(n_hops + n_extra)]
        # emission i covers the input span [i*hop - lookahead, (i+1)*hop - lookahead)
        full = np.concatenate(outs, axis=-1)
        return full[:, self.lookahead: self.lookahead + t]
