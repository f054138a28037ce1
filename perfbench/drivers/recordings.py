"""One client separating one recording at a time, closed loop, through
``OverlapAddSeparator.separate`` with ``sudo-torch-separate``'s defaults
(chunks of ``chunk_seconds``, ``batch_chunks`` chunks a forward, the
serving forward at its card default). A request is handed a mixture in host
memory and ends holding the separated sources there.

Every seed serves the same set of ``n_recordings`` lengths, log-spaced
between ``min_seconds`` and ``max_seconds`` (the midpoints of equal steps
of log-length); the seed draws their audio and the order of each pass over
the set. The audio, with nothing below ``highpass_hz``, is made on the card
in set-up and copied to the host once.

Traffic keys: those above, ``sample`` (recordings kept for the check,
drawn from the seed; the longest recording's last answer is always kept)
and ``limits``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from perfbench import core, flops, signals, weights
from perfbench.reference import improved as ref
from perfbench.reference import overlap_add as ref_oa


def recording_lengths(traffic: dict, fs: int) -> np.ndarray:
    n = int(traffic["n_recordings"])
    lo, hi = np.log(traffic["min_seconds"]), np.log(traffic["max_seconds"])
    return np.round(np.exp(lo + (np.arange(n) + 0.5) / n * (hi - lo)) * fs).astype(np.int64)


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.hp, tr = cell.config, cell.traffic
        self.fs = int(cell.config["fs"])
        self.chunk = int(round(tr["chunk_seconds"] * self.fs))
        self.batch_chunks = int(tr["batch_chunks"])
        self.lengths = recording_lengths(tr, self.fs)
        self.longest = int(np.argmax(self.lengths))
        self.order_rng = np.random.default_rng(core.sub_seed(seed, "order"))
        self.order: list = []
        self.sample = core.Reservoir(int(tr["sample"]), core.sub_seed(seed, "sample"))

    def setup(self) -> None:
        from sudo_rm_rf_tpu_torch.inference.overlap_add import OverlapAddSeparator
        from sudo_rm_rf_tpu_torch.models.fast_inference import cast_model, improved_forward_fast

        self.phases = core.Phases()
        core.fp32_strict(torch)
        serve = self.hp["serve"]
        model, self.flat, self.names = weights.improved_model(
            torch, self.hp, core.sub_seed(self.seed, "weights"), self.device)
        self.phases.mark("weights")
        served = cast_model(model.eval(), serve["compute_dtype"], serve["impl"])
        gen = torch.Generator(device=self.device).manual_seed(core.sub_seed(self.seed, "inputs"))
        longest = int(self.lengths.max())
        audio = signals.mixtures(torch, len(self.lengths), longest, gen, self.device,
                                 highpass_hz=self.cell.traffic["highpass_hz"], fs=self.fs)
        audio = audio.cpu().numpy()
        self.mixtures = [np.ascontiguousarray(audio[k, :n]) for k, n in enumerate(self.lengths)]
        self.phases.mark("inputs")
        self.separator = OverlapAddSeparator(
            served, chunk_samples=self.chunk, num_sources=self.hp["num_sources"],
            batch_chunks=self.batch_chunks,
            forward_fn=functools.partial(improved_forward_fast, served, impl=serve["impl"],
                                         compute_dtype=serve["compute_dtype"]))
        # the one forward shape, both branches of separate: one chunk, many
        self.separator.separate(self.mixtures[int(np.argmin(self.lengths))])
        self.separator.separate(self.mixtures[self.longest])
        core.sync(torch, self.device)
        self.phases.mark("warm")

    def _next(self) -> int:
        if not self.order:
            self.order = list(self.order_rng.permutation(len(self.lengths)))
        return int(self.order.pop())

    def _request(self, i: int) -> None:
        k = self._next()
        self.served.append(k)
        out = self.separator.separate(self.mixtures[k])
        if k == self.longest:
            self.longest_answer = out
        self.sample.offer((k, out))

    def window(self, seconds: float) -> dict:
        from sudo_rm_rf_tpu_torch.ops.uconv import fused_uconv_block

        self.longest_answer, self.served = None, []
        k1 = fused_uconv_block.launches
        loop = core.closed_loop(self._request, seconds)
        self.k1_launches = fused_uconv_block.launches - k1
        self.count, self.latencies_s = loop["count"], loop["latencies_s"]
        return {"attempted": self.count, "failed": 0,
                "metrics": {"latency_p95_ms": 1e3 * core.percentile(loop["latencies_s"], 95)},
                "diag": {q: 1e3 * core.percentile(loop["latencies_s"], q) for q in (5, 50, 99)}}

    def trace_info(self) -> dict:
        t = flops.frames(self.hp, self.chunk)
        return {"units": self.count,
                "counters": {"k1_launches": self.k1_launches},
                "shapes": {"k1": (self.batch_chunks, self.hp["out_channels"],
                                  self.hp["in_channels"], t, self.hp["upsampling_depth"])}}

    def release(self) -> None:
        del self.separator
        core.free(torch, self.device)

    # -- the check ------------------------------------------------------------

    def _chunk_forward(self, tf32: bool):
        w = weights.unflatten(self.flat, self.names)

        def forward(frames: np.ndarray) -> np.ndarray:
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            try:
                x = torch.from_numpy(frames.astype(np.float32)).to(self.device)
                with torch.no_grad():
                    return ref.forward(w, self.hp, x).cpu().numpy()
            finally:
                core.fp32_strict(torch)

        return forward

    def _reference(self, k: int, tf32: bool = False, follow=None, choices=None) -> np.ndarray:
        return ref_oa.separate(self.mixtures[k], self.chunk, self.hp["num_sources"],
                               self._chunk_forward(tf32), self.batch_chunks, follow, choices)

    def _answers(self):
        answers = list(self.sample.items)
        if self.longest_answer is not None:
            answers.append((self.longest, self.longest_answer))
        return answers

    def _compare(self, answers) -> dict:
        """Worst relative L2 error of one separated source of one recording
        against the reference's, which follows the answer's own choice
        where a permutation choice ties; beside it, what the alignment's
        choices read: how many were judged, how many lay in the tie band,
        the narrowest margin, and the widest at which the answer took
        another branch than the reference's best."""
        worst, choices = 0.0, []
        for k, out in answers:
            got = np.asarray(out, np.float64)
            r = torch.from_numpy(self._reference(k, follow=got, choices=choices))
            err = (torch.from_numpy(got) - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-12)
            worst = max(worst, core.worst(err))
        margins = [m for m, _ in choices]
        other = [m for m, best in choices if best is False]
        return {"rel_err_max": worst, "choices": len(choices),
                "in_tie_band": sum(m <= ref_oa.TIE for m in margins),
                "margin_min": min(margins, default=None),
                "other_branch_margin_max": max(other, default=None)}

    def judge(self) -> dict:
        return self._compare(self._answers())

    def control_judge(self) -> dict:
        ks = sorted({k for k, _ in self._answers()})
        return self._compare([(k, self._reference(k, tf32=True)) for k in ks])
