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
``torch.inference_mode``. ``num_streams`` live streams share one
(N, 1, context + hop) window and are stepped as one batched forward; each
stream's emissions are its own, what a single-stream separator fed that
stream alone gives. On an H100 that holds bit for bit with
``torch.backends.cudnn.deterministic``; by default cuDNN's transposed conv
(the decoder) may add with atomics, and any two forwards of one window,
batched or not, can then differ by an ulp at a few outputs.

On a CUDA device, a model with ``stages()`` (the causal SuDoRM-RF) is
captured on the first push as one CUDA graph a stage over the fixed
window, and each later step replays them: the same kernels on the same
buffers, so the same samples, for some 20 host launches in place of the
eager forward's ~580 (whose dispatch, not the card, would set a step's
time). The graphs read the model's parameters in place: load new weights
with ``copy_``, or make a new separator.

A push records spans (``utils/tracing.py``): ``stream.step``, the root,
with ``stream.upload`` (the samples to the device), ``stream.roll`` (the
window's shift and append), the model's own ``forward`` spans and
``stream.fetch`` (the emitted slice, the wait for the device and the copy
back). Replayed, the forward keeps its spans, one a stage's replay, and
``CausalConv1d.mask_applies`` still counts the mask multiplies each replay
runs. ``StreamingSeparator.steps`` counts the steps of every instance.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sudo_rm_rf_tpu_torch import ops
from sudo_rm_rf_tpu_torch.models.causal_sudormrf import CausalConv1d
from sudo_rm_rf_tpu_torch.utils import tracing


class _StageGraphs:
    """``model``'s forward over the static ``window`` (N, 1, W) as one CUDA
    graph a stage of ``model.stages()``, captured into one memory pool;
    calling it replays them under the forward's spans and returns the
    static (N, S, W) output, overwritten by the next call."""

    def __init__(self, model, window: torch.Tensor):
        device = window.device
        # one eager forward first, off the capture: the library's handles,
        # workspaces and algorithm choices are made outside the graphs
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            model(window)
        torch.cuda.current_stream(device).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        self.rows = window.shape[0]
        self.graphs = []
        x = window
        for name, stage in model.stages():
            masks = CausalConv1d.mask_applies
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                x = stage(x)
            self.graphs.append((name, graph, CausalConv1d.mask_applies - masks))
            CausalConv1d.mask_applies = masks  # recorded, not run: a replay counts them
        self.out = ops.unpad_to_length(x, window.shape[-1])

    def __call__(self) -> torch.Tensor:
        with tracing.span("forward", rows=self.rows):
            for name, graph, masks in self.graphs:
                with tracing.span(name):
                    graph.replay()
                CausalConv1d.mask_applies += masks
        return self.out


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
      num_streams: N, the live streams stepped together.
    """

    # steps of every instance, one a push
    steps = 0

    def __init__(self, model, hop_samples: int, context_samples: int,
                 num_sources: int = 2, lookahead_samples: Optional[int] = None,
                 num_streams: int = 1):
        self.hop = int(hop_samples)
        self.context = int(context_samples)
        self.num_sources = num_sources
        self.num_streams = int(num_streams)
        if self.num_streams < 1:
            raise ValueError(f"num_streams must be at least 1, got {num_streams}")
        if lookahead_samples is None:
            granule = getattr(model, "n_least_samples_req", None)
            lookahead_samples = int(granule) if granule else self.hop
        self.lookahead = int(lookahead_samples)
        if self.lookahead > self.context:
            raise ValueError("lookahead must not exceed the context")
        self.model = model
        self.device = next(model.parameters()).device
        self._graphs = None
        self._graphable = self.device.type == "cuda" and hasattr(model, "stages")
        self._buffer = None
        self._window = self.context + self.hop
        # the emitted hop: the window's span ending ``lookahead`` samples
        # behind the newest input
        self._emit = slice(self._window - self.lookahead - self.hop,
                           self._window - self.lookahead)
        self.reset()

    def reset(self):
        if self._buffer is None:
            self._buffer = torch.zeros((self.num_streams, 1, self._window),
                                       device=self.device)
        else:  # in place: the graphs read this buffer
            self._buffer.zero_()

    def _roll(self, hops: torch.Tensor) -> None:
        """Shift every stream's window by one hop and append ``hops`` (N, hop)."""
        self._buffer.copy_(torch.cat([self._buffer[..., self.hop:], hops[:, None]], dim=-1))

    def _forward(self) -> torch.Tensor:
        if self._graphable and self._graphs is None:
            self._graphs = _StageGraphs(self.model, self._buffer)
        return self._graphs() if self._graphs is not None else self.model(self._buffer)

    def push(self, hop_audio) -> np.ndarray:
        """Feed exactly ``hop_samples`` new samples of every stream, (N, hop)
        (or (hop,) with one stream); returns the (N, S, hop) estimates
        ((S, hop) for a 1-D push) of the span ending ``lookahead`` samples
        behind the newest input."""
        with tracing.span("stream.step", streams=self.num_streams, hop=self.hop):
            with tracing.span("stream.upload"):
                hops = np.asarray(hop_audio, np.float32)
                flat = hops.ndim == 1 and self.num_streams == 1
                if flat:
                    hops = hops[None]
                if hops.shape != (self.num_streams, self.hop):
                    raise ValueError(
                        f"push expects exactly {self.hop} samples for each of "
                        f"{self.num_streams} streams, (N, hop) = "
                        f"({self.num_streams}, {self.hop}), got shape {hops.shape}")
                hops = torch.as_tensor(hops).to(self.device)
            with torch.inference_mode():
                with tracing.span("stream.roll"):
                    self._roll(hops)
                est = self._forward()
                with tracing.span("stream.fetch"):
                    out = est[:, :, self._emit].cpu().numpy()
            StreamingSeparator.steps += 1
        return out[0] if flat else out

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
