"""Live streams stepped block-online as one batch, closed loop, one step in
flight: ``StreamingSeparator(num_streams=streams)`` with the causal
SuDoRM-RF v3. A request is one ``push`` of every stream's next hop, from
host memory to the (streams, S, hop) estimates in host memory; its latency
feeds ``latency_p95_ms`` (nearest rank over every step of the window).

Each stream's audio is ``audio_seconds`` of two-source brown-noise
mixture with nothing below ``highpass_hz`` (the recordings cell's audio),
made on the card from the seed in set-up, copied to host memory once and
looped. Set-up pushes as many hops as fill the window, so every window of
the timed steps is full; that warms the one shape the traffic uses.

The check rebuilds each sampled step's windows from the audio
(``reference/causal.py``'s streaming rule) and compares every stream's
emitted hop with the reference forward's slice of the same window.

Traffic keys: ``streams``, ``hop_samples``, ``context_samples``,
``lookahead_samples``, ``audio_seconds``, ``highpass_hz``, ``sample``
(steps kept for the check, drawn from the seed) and ``limits``.
Configuration keys: the model's hparams, ``fs``, ``skipinit_gain``.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from perfbench import core, flops_causal, signals, weights
from perfbench.reference import causal as ref

MODEL_KEYS = ("in_audio_channels", "out_channels", "in_channels", "num_blocks",
              "upsampling_depth", "enc_kernel_size", "enc_num_basis", "num_sources")


def _law_shape(name: str, shape: tuple) -> tuple:
    """The shape ``weights._leaf_law`` is given for a leaf: a block's scalar
    ``skipinit_gain`` as a 1x1 conv's weight (its draw is overwritten)."""
    return (1, 1, 1) if name.endswith("skipinit_gain") else shape


def causal_model(torch, hp: dict, seed: int, device):
    """The program's ``CausalSuDORMRF`` at ``hp``, its params filled from one
    seeded flat draw on ``device`` and every block's ``skipinit_gain`` set
    to ``hp['skipinit_gain']``; returns (model, the flat weights, their
    (name, shape) order)."""
    from sudo_rm_rf_tpu_torch.models import CausalSuDORMRF

    model = CausalSuDORMRF(**{k: hp[k] for k in MODEL_KEYS}, device=device)
    named_shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    flat = weights.draw_flat(torch, [(n, _law_shape(n, s)) for n, s in named_shapes],
                             seed, device)
    views = weights.unflatten(flat, named_shapes)
    for n, _ in named_shapes:
        if n.endswith("skipinit_gain"):
            views[n].fill_(float(hp["skipinit_gain"]))
    # the params get a copy of their own: the program may change them in place
    torch.nn.utils.vector_to_parameters(flat.clone(), list(model.parameters()))
    return model, flat, named_shapes


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.hp, tr = cell.config, cell.traffic
        self.streams, self.hop = int(tr["streams"]), int(tr["hop_samples"])
        self.window_n = int(tr["context_samples"]) + self.hop
        self.lookahead = int(tr["lookahead_samples"])
        self.n_audio = int(round(tr["audio_seconds"] * cell.config["fs"]))
        self.warm = -(-self.window_n // self.hop)  # hops that fill the window
        self.sample = core.Reservoir(int(tr["sample"]), core.sub_seed(seed, "sample"))

    def setup(self) -> None:
        from sudo_rm_rf_tpu_torch.inference import StreamingSeparator

        if "num_streams" not in inspect.signature(StreamingSeparator).parameters:
            raise core.BenchError("this tree's StreamingSeparator has no num_streams: "
                                  "it steps one stream only")
        self.phases = core.Phases()
        core.fp32_strict(torch)
        model, self.flat, self.names = causal_model(
            torch, self.hp, core.sub_seed(self.seed, "weights"), self.device)
        self.phases.mark("weights")
        gen = torch.Generator(device=self.device).manual_seed(core.sub_seed(self.seed, "inputs"))
        audio = signals.mixtures(torch, self.streams, self.n_audio, gen, self.device,
                                 highpass_hz=self.cell.traffic["highpass_hz"],
                                 fs=self.hp["fs"])
        self.audio = np.ascontiguousarray(audio.cpu().numpy())
        del audio
        self.phases.mark("inputs")
        self.separator = StreamingSeparator(
            model.eval(), hop_samples=self.hop,
            context_samples=self.window_n - self.hop, num_sources=self.hp["num_sources"],
            lookahead_samples=self.lookahead, num_streams=self.streams)
        for t in range(self.warm):
            self.separator.push(self._hops(t))
        core.sync(torch, self.device)
        self.phases.mark("warm")

    def _hops(self, t: int) -> np.ndarray:
        """Every stream's hop ``t`` (0-based), round the end of its audio."""
        return ref.windows(self.audio, t, self.hop, self.hop)

    def _request(self, i: int) -> None:
        t = self.warm + i
        self.sample.offer((t, self.separator.push(self._hops(t))))

    def window(self, seconds: float) -> dict:
        from sudo_rm_rf_tpu_torch.inference import StreamingSeparator
        from sudo_rm_rf_tpu_torch.models.causal_sudormrf import CausalConv1d

        # a program without a counter gives no count, and its counter is left out
        before = {"steps": getattr(StreamingSeparator, "steps", None),
                  "mask_applies": getattr(CausalConv1d, "mask_applies", None)}
        loop = core.closed_loop(self._request, seconds)
        after = {"steps": getattr(StreamingSeparator, "steps", None),
                 "mask_applies": getattr(CausalConv1d, "mask_applies", None)}
        self.counters = {k: after[k] - v for k, v in before.items() if v is not None}
        self.count = loop["count"]
        return {"attempted": self.count, "failed": 0,
                "metrics": {"latency_p95_ms": 1e3 * core.percentile(loop["latencies_s"], 95)},
                "diag": {q: 1e3 * core.percentile(loop["latencies_s"], q) for q in (5, 50, 99)}}

    def trace_info(self) -> dict:
        return {"units": self.count,
                "counters": self.counters,
                "shapes": {"forward_flops": flops_causal.forward_flops(
                    self.hp, self.streams, self.window_n)}}

    def release(self) -> None:
        del self.separator
        core.free(torch, self.device)

    # -- the check ------------------------------------------------------------

    def _reference(self, t: int, tf32: bool = False) -> torch.Tensor:
        """(streams, S, hop) that the reference emits at step ``t``."""
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            w = weights.unflatten(self.flat, self.names)
            x = torch.from_numpy(ref.windows(self.audio, t, self.hop, self.window_n))
            with torch.no_grad():
                est = ref.forward(w, self.hp, x[:, None].to(self.device))
            return ref.emitted(est, self.hop, self.lookahead).cpu()
        finally:
            core.fp32_strict(torch)

    def _compare(self, answers) -> dict:
        """Worst relative L2 error over its hop of one source of one stream,
        over the sampled steps, against the fp32 reference of its window."""
        worst = 0.0
        for t, est in answers:
            r = self._reference(t).double()
            got = torch.as_tensor(np.asarray(est)).double()
            err = (got - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-12)
            worst = max(worst, core.worst(err))
        return {"rel_err_max": worst}

    def judge(self) -> dict:
        return self._compare(self.sample.items)

    def control_judge(self) -> dict:
        steps = sorted({t for t, _ in self.sample.items})
        return self._compare([(t, self._reference(t, tf32=True)) for t in steps])
