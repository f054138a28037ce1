"""Offline separation of a corpus in fixed batches with GroupComm SuDoRM-RF
v2: ``serve_batches``'s ring, closed loop, sample and check, with the
model ``GroupCommSuDORMRF`` served through ``groupcomm_forward_fast`` (TAC,
then K1 on the group-folded layout) and held to
``reference/groupcomm.py``.

Traffic keys: those of ``serve_batches``. Configuration keys: the model's
hparams (``group_size``, ``in_audio_channels`` besides the Improved ones),
``fs``, ``serve`` (``impl``, ``compute_dtype``).
"""

from __future__ import annotations

import torch

from perfbench import core, flops, flops_gc, signals, weights
from perfbench.drivers import serve_batches
from perfbench.reference import groupcomm as ref

MODEL_KEYS = ("in_audio_channels", "out_channels", "in_channels", "num_blocks",
              "upsampling_depth", "enc_kernel_size", "enc_num_basis", "num_sources",
              "group_size")


def _law_shape(shape: tuple) -> tuple:
    """The shape ``weights._leaf_law`` is given for a leaf: TAC's 2-D Linear
    weights as the 1x1 convs they are, (out, in, 1), so that they and their
    biases draw uniform in +-1/sqrt(in), as ``groupcomm_sudormrf.Linear``
    draws them."""
    return shape + (1,) if len(shape) == 2 else shape


def gc_model(torch, hp: dict, seed: int, device):
    """The program's ``GroupCommSuDORMRF`` at ``hp``, its params filled from
    one seeded flat draw on ``device``; returns (model, the flat weights,
    their (name, shape) order)."""
    from sudo_rm_rf_tpu_torch.models import GroupCommSuDORMRF

    with torch.device("meta"):
        model = GroupCommSuDORMRF(**{k: hp[k] for k in MODEL_KEYS})
    model = model.to_empty(device=device)
    named_shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    flat = weights.draw_flat(torch, [(n, _law_shape(s)) for n, s in named_shapes], seed,
                             device)
    # the params get a copy of their own: the program may change them in place
    torch.nn.utils.vector_to_parameters(flat.clone(), list(model.parameters()))
    return model, flat, named_shapes


class Driver(serve_batches.Driver):
    def setup(self) -> None:
        from sudo_rm_rf_tpu_torch.models.fast_inference import cast_model, groupcomm_forward_fast

        self.phases = core.Phases()
        core.fp32_strict(torch)
        serve = self.cell.config["serve"]
        model, self.flat, self.names = gc_model(
            torch, self.hp, core.sub_seed(self.seed, "weights"), self.device)
        self.phases.mark("weights")
        served = cast_model(model.eval(), serve["compute_dtype"], serve["impl"])
        gen = torch.Generator(device=self.device).manual_seed(core.sub_seed(self.seed, "inputs"))
        self.ring = signals.mixtures(torch, self.ring_n * self.batch, self.n_samples, gen,
                                     self.device).view(self.ring_n, self.batch, self.n_samples)
        self.forward = lambda x: groupcomm_forward_fast(
            served, x, impl=serve["impl"], compute_dtype=serve["compute_dtype"])
        self.phases.mark("inputs")
        for i in range(2):  # the one shape this traffic uses: K1's build, cuBLAS, cuDNN
            self._run(i)
        core.sync(torch, self.device)
        self.phases.mark("warm")

    def window(self, seconds: float) -> dict:
        from sudo_rm_rf_tpu_torch.models.groupcomm_sudormrf import _tac_fast

        # a program without the counter gives no count: tac_ms.gc then reads None
        before = getattr(_tac_fast, "calls", None)
        out = super().window(seconds)
        self.tac_calls = None if before is None else _tac_fast.calls - before
        return out

    def trace_info(self) -> dict:
        hp, g = self.hp, self.hp["group_size"]
        counters = {"k1_launches": self.k1_launches}
        if self.tac_calls is not None:
            counters["tac_calls"] = self.tac_calls
        return {"units": self.count,
                "counters": counters,
                "shapes": {"k1": (self.batch * g, hp["out_channels"] // g,
                                  hp["in_channels"] // g, flops.frames(hp, self.n_samples),
                                  hp["upsampling_depth"]),
                           "forward_flops": flops_gc.forward_flops(hp, self.batch,
                                                                   self.n_samples)}}

    def _reference(self, slot: int, tf32: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            w = weights.unflatten(self.flat, self.names)
            with torch.no_grad():
                return ref.forward(w, self.hp, self.ring[slot]).cpu()
        finally:
            core.fp32_strict(torch)
