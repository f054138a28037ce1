"""Offline separation of a corpus in fixed batches, closed loop, one batch in
flight: ``improved_forward_fast`` on a batch resident on the card, then its
estimates copied to host memory (as ``sudo-torch-separate`` does before it
writes). The batches are a ring of distinct seeded mixtures made on the card
in set-up.

Traffic keys: ``batch``, ``seconds_per_example``, ``ring`` (distinct
batches), ``sample`` (answers kept for the check, drawn from the seed),
``limits``. Configuration keys: the model's hparams, ``fs``, ``serve``
(``impl``, ``compute_dtype``).
"""

from __future__ import annotations

import torch

from perfbench import core, flops, signals, weights
from perfbench.reference import improved as ref


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.hp = cell.config
        tr = cell.traffic
        self.batch, self.ring_n = int(tr["batch"]), int(tr["ring"])
        self.example_s = float(tr["seconds_per_example"])
        self.n_samples = int(round(self.example_s * cell.config["fs"]))
        self.sample = core.Reservoir(int(tr["sample"]), core.sub_seed(seed, "sample"))

    def setup(self) -> None:
        from sudo_rm_rf_tpu_torch.models.fast_inference import cast_model, improved_forward_fast

        self.phases = core.Phases()
        core.fp32_strict(torch)
        serve = self.cell.config["serve"]
        model, self.flat, self.names = weights.improved_model(
            torch, self.hp, core.sub_seed(self.seed, "weights"), self.device)
        self.phases.mark("weights")
        served = cast_model(model.eval(), serve["compute_dtype"], serve["impl"])
        gen = torch.Generator(device=self.device).manual_seed(core.sub_seed(self.seed, "inputs"))
        self.ring = signals.mixtures(torch, self.ring_n * self.batch, self.n_samples, gen,
                                     self.device).view(self.ring_n, self.batch, self.n_samples)
        self.forward = lambda x: improved_forward_fast(
            served, x, impl=serve["impl"], compute_dtype=serve["compute_dtype"])
        self.phases.mark("inputs")
        for i in range(2):  # the one shape this traffic uses: K1's build, cuBLAS, cuDNN
            self._run(i)
        core.sync(torch, self.device)
        self.phases.mark("warm")

    def _run(self, i: int):
        return self.forward(self.ring[i % self.ring_n]).cpu()

    def _request(self, i: int) -> None:
        self.sample.offer((i % self.ring_n, self._run(i)))

    def window(self, seconds: float) -> dict:
        from sudo_rm_rf_tpu_torch.ops.uconv import fused_uconv_block

        k1 = fused_uconv_block.launches
        loop = core.closed_loop(self._request, seconds)
        self.k1_launches = fused_uconv_block.launches - k1
        self.count = loop["count"]
        audio = self.count * self.batch * self.example_s
        return {"attempted": self.count, "failed": 0,
                "metrics": {"serve_audio_s_per_s": audio / loop["elapsed_s"]},
                "diag": {q: 1e3 * core.percentile(loop["latencies_s"], q) for q in (5, 50, 95)}}

    def trace_info(self) -> dict:
        t = flops.frames(self.hp, self.n_samples)
        return {"units": self.count,
                "counters": {"k1_launches": self.k1_launches},
                "shapes": {"k1": (self.batch, self.hp["out_channels"], self.hp["in_channels"],
                                  t, self.hp["upsampling_depth"]),
                           "forward_flops": flops.forward_flops(self.hp, self.batch,
                                                                self.n_samples)}}

    def release(self) -> None:
        del self.forward
        core.free(torch, self.device)

    # -- the check ------------------------------------------------------------

    def _reference(self, slot: int, tf32: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            w = weights.unflatten(self.flat, self.names)
            with torch.no_grad():
                return ref.forward(w, self.hp, self.ring[slot]).cpu()
        finally:
            core.fp32_strict(torch)

    def _compare(self, outputs) -> dict:
        """Worst relative L2 error of one source of one row, over the
        sampled answers, against the fp32 reference of their batch."""
        worst, refs = 0.0, {}
        for slot, est in outputs:
            if slot not in refs:
                refs[slot] = self._reference(slot)
            r = refs[slot].double()
            err = (est.double() - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-12)
            worst = max(worst, core.worst(err))
        return {"rel_err_max": worst}

    def judge(self) -> dict:
        return self._compare(self.sample.items)

    def control_judge(self) -> dict:
        slots = sorted({slot for slot, _ in self.sample.items})
        return self._compare([(s, self._reference(s, tf32=True)) for s in slots])
