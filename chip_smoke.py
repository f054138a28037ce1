"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

1. Print the card (``nvidia-smi`` name and power limit) and the torch build;
   fail without CUDA. TF32 is off, so fp32 is compared with fp32.
2. Build the CUDA kernels from ``sudo_rm_rf_tpu_torch/csrc``; print each
   kernel's registers and spills, and the count of tensor-core instructions
   (``HGMMA``/``HMMA``) in the GEMM kernels' SASS where ``cuobjdump`` exists
   (failing if it is 0).
3. The U-ConvBlock kernel (K1) against its plain version at the flagship
   block shape (Co=256, Ci=512, T=3200, depth 5; B=1, 4, 8), at two ragged
   ones, at the GroupComm folded shape (B*G=64, Co=16, Ci=32, T=3200,
   depth 5), at the U36 WHAMR! 16 kHz block (Co=Ci=512, T=6400, depth 5;
   B=1, 4) and at the U8/256 block of the convergence check's validation
   (B=4, Co=128, Ci=256, T=1600, depth 5), within rtol=atol=1e-4; two calls
   on one input must be bit-identical. At the u36_wide block (Co=512,
   Ci=2048, T=3200, depth 5; B=1, 4), with each pyramid, against
   ``uconv_block_levelwise`` with the same pyramid: fp32 within rtol = atol
   = 1e-4, bf16 outside it only by the bf16 pyramid's rounding flips (10.),
   two calls bit-identical; its time, the plain version's, its bound,
   yardstick and (B=4) parts. At every shape K1 runs on the main paths
   (the flagship at bs32 and bs8, U36 at bs4, GroupComm's folded bs32,
   u36_wide, U8/256, the 10-minute block): each 1x1 product's GEMM route
   (wide from 128 output and input channels: the library's chooser against
   ``ops/uconv.py::gemm_wide``), ``gemm_wide_launches`` a call, and the
   GEMMs' device time a call by route (``torch.profiler``). At the flagship
   and U36 shapes, time the kernel, ``uconv_block_fma`` and
   ``uconv_block_reference`` (CUDA events, median of 25 after warm-up). At
   B=4 of both and at the GroupComm shape, also: the
   device time of each of K1's parts (``torch.profiler``), K1's bound, and
   the ``torch.matmul`` time of the
   same two products (TF32 off, and labelled, on), a yardstick the port
   never calls. Then TAC's kernel (``tac``: ``ops/tac.py::fused_tac``,
   ``csrc/tac.cu``) against its plain version at the gc-u16-batch32 cell's
   TAC (32, 16, 16, 3200), the 10-minute pass's (1, 16, 16, 480000; three
   launches) and narrow and wide groups with odd lengths, within rtol 1e-4,
   atol 1e-5, two calls bit-identical; at the first two, its time and each
   pass's device time beside its floors, the plain version's time and the
   ``torch.matmul`` time of its three products.
4. The serving path: ``sudo-torch-separate`` with a seeded random Improved
   SuDoRM-RF U16/512 checkpoint on three synthetic 8 kHz wavs (3 s, 10 s,
   25 s), batch 4. Checks the outputs, that the kernel ran 16 times per
   forward batch, and one file against a separation through the plain
   blocks. Then kernel-vs-plain fidelity of one 4 s bs4 forward (>= 80 dB),
   the bs4 fp32 forward time of each block form, and the kernel forward's
   device time by kernel with the device's idle share.
5. The same for GroupComm SuDoRM-RF v2 U16/512 (group 16):
   ``sudo-torch-separate --model_type groupcomm_v2 --mixture_consistency
   uniform``, K1 launched 16 times per forward batch in the group-folded
   layout, one file against the ``xla`` blocks (1 LSB), fidelity of the
   ``kernel`` forward against ``xla`` (>= 80 dB), and the time of every
   ``groupcomm_forward_fast`` impl.
6. The training path: ``sudo-torch-train`` on a WHAM-layout directory of 16
   train and 8 val synthetic 4 s wavs, U16/512, batch 4, ``block_impl fma``,
   fp32: 2 epochs (8 steps) saving a checkpoint each epoch, then again with
   ``--resume`` for a third. Checks that every step's loss is finite, that
   val SISDRi is printed each epoch, the checkpoint files, that the resumed
   run starts at epoch 3 with Adam's step at 8, and that training launched
   K1 0 times (it trains through the fma blocks, as the JAX package does).
   The trained weights then go through ``sudo-torch-separate`` (K1 launches
   counted). One train step of the same model on the card and on the CPU,
   from the same weights, batch and draws: loss and grad norm within 1e-3
   relative. The median train-step time (CUDA events, 3 steps after 3
   warm-up) and peak memory of the fma and xla blocks, each in fp32 and
   bf16, with each step's device busy time, idle share, device launches and
   top kernels (``torch.profiler``).
7. GroupComm training on the same corpus: ``sudo-torch-train --model_type
   groupcomm_v2 --block_impl fma --mixture_consistency uniform`` for one
   epoch (finite losses, val SISDRi printed, 0 K1 launches), one step card
   vs CPU (1e-3), and the step times of the fma and xla blocks in fp32.
8. Evaluation of the published Improved SuDoRM-RF U36/Bases4096 WHAMR!
   configuration (out 512, in 512, 36 blocks, 4096 bases; seeded random
   weights) at 16 kHz: ``sudo-torch-evaluate`` on a synthetic WHAMR-layout
   test split of 8 files, in 4 s crops at batch 4 and then in full length
   on two files of which one is longer than the chunk; K1 counted 36 times
   per forward batch, every summary key present and finite. One batch's
   SI-SDRi through the kernel and the ``xla`` blocks (<= 0.01 dB apart),
   kernel-vs-xla fidelity of a bs4 forward (>= 80 dB), the bs4 fp32
   forward time of each block form, the kernel forward's device idle share
   and top kernels, and the time of one batch's BSS-eval (512 and 1 taps)
   and SI-SDRi.
9. The WHAMR! (noisy_reverberant, U16 out 256 / 2048 bases, 8 kHz) and FUSS
   (U16 out 128 / 512 bases, 4 sources, 16 kHz, uniform mixture
   consistency) recipes at the JAX package's run configurations, batch 8:
   one ``sudo-torch-train`` epoch each on a synthetic corpus (finite losses,
   the val metrics printed, 0 K1 launches), one step card vs CPU (1e-3)
   and the fp32 ``fma`` step time.
10. K1 with a bf16 pyramid (``pyramid_dtype=torch.bfloat16``) at the
   flagship B=4, the GroupComm folded and the U36 B=4 shapes, against its
   plain version (``uconv_block_levelwise`` with the same pyramid, on the
   card): >= 80 dB on the block's change (out - x), |delta| <= 2e-3 but at
   bf16 rounding flips (at most 1e-5 of the outputs, none past 1e-2; the
   plain version's own fp32-vs-float64 spread printed beside), two calls
   bit-identical; its distance to the fp32 pyramid's output, its time
   and parts beside the fp32 pyramid's (in turns), the upsum's bound from
   the halved level bytes. Then K1 and the fp32 plain block against a
   float64 plain block at K = Co = 256 and 512, and their error growth;
   K1's beside the figures of the tree before the wide GEMM (PERF.md
   section 6), within 1.25x of them.
11. bf16 serving of Improved and GroupComm U16/512: every impl of the fast
   forward with ``compute_dtype="bfloat16"`` (and ``kernel`` with the bf16
   pyramid, K1's bf16 pyramid's main path) from a copy cast once for it,
   >= 35 dB from its own fp32 forward, K1 counted, kernel against
   xla, bs4 and bs8 times. int8 serving (``models/quantized.py``) of both at
   bs8: dynamic and static fidelity against the fp32 serving forward, the 25
   dB gate, times, and ``aten::_int_mm`` once a quantized site on the card.
12. ``sudo-torch-bench`` at the zoo's U16/512, GroupComm and U36 rows (bs1
   and bs4, fp32 and bf16) and one backward row, K1 counted; then
   ``python -m sudo_rm_rf_tpu_torch.bench``, its line and gates (3 timed
   calls a row).
13. The AUGMENTED loop at the widths of
   ``docs/runs/improved_u16_synth/hparams.json`` (U16/512, out 256, bs8, 4 s
   at 8 kHz, the xla blocks in bf16): a hierarchical corpus (cut to 12 x 8
   train and 4 x 6 val and test utterances; 64 / 16 / 16 mixtures), two
   ``sudo-torch-train --train AUGMENTED_WSJMIX`` epochs saving msgpack
   TrainStates and a third resumed from them (step and Adam step checked),
   ``sudo-torch-evaluate --dataset AUGMENTED`` of the best checkpoint (16 K1
   launches a batch) beside the ``xla`` blocks' SI-SDRi (<= 0.01 dB apart),
   ``sudo-torch-export`` to a ``.pt``, and ``sudo-torch-separate`` of two
   files from the ``.pt`` and from the msgpack: identical int16 outputs.
14. Causal SuDoRM-RF v3 at the JAX class defaults (U16/512, out 128, depth
   4, skip-init gains set to 0.2): the bs4 fp32 forward (ms, idle share,
   device launches, 0 K1 launches), card against CPU on a bs1 forward
   (>= 80 dB), ``StreamingSeparator`` on the card (hop 160, a context that
   covers the model's reach: streamed against offline past it >= 80 dB,
   a half-length stream emitting bit-identical samples), the host time of
   one push at ``scripts/bench_streaming.py``'s settings, ``python -m
   sudo_rm_rf_tpu_torch.bench_streaming`` for 1 and 16 streams, and one bs4
   fp32 train step (ms, idle share, peak memory).
15. SuDoRM-RF v1 (U16/512, out 128, depth 4) and attentive v1, v2 and v3
   (U16/512, out 256, depth 5): the bs4 fp32 forward (ms, idle share,
   launches, peak, 0 K1 launches), card against CPU on a bs1 forward (>= 80
   dB), one bs4 train step each (the attentive ones with ``train_dropout``:
   ms, idle share, peak memory). ``remat_blocks`` on Improved U16/512 bs4
   (fma): one step's grads against the plain step's (<= 1e-4 of each
   tensor's largest), the step's ms and peak memory with and without it.
16. ``sudo-torch-separate`` of one 6 s wav on the card for ``causal``,
   ``softmax`` and ``attention_v2``, from a ``.pt`` and from a msgpack
   TrainState of the same weights: identical int16, 0 K1 launches.
17. The baselines at their published configurations (ConvTasNet, DPRNN,
   Demucs, TDCN, ResidualTN and SepFormer at the JAX class defaults; seeded
   random weights): the bs4 fp32 forward (ms, idle share, launches, peak),
   card against CPU on a bs1 forward (>= 80 dB), one bs4 ``radam_cosine``
   train step each and SepFormer's at bs1 too (ms, idle share, peak, a
   finite loss), 0 K1 launches over each model's path; ``sudo-torch-bench``
   at the JAX zoo's five baseline rows (bs1 and bs4); ``sudo-torch-train
   --optimizer radam_cosine`` on Improved U16/512's widths cut to one block
   (its host-bound step would take ~9 min here) for one epoch of 1001 1.5 s
   files at batch 1 (the JAX trainer's warmup of 1000 updates needs more
   steps than that) and a resumed second, its counts checked.
18. MUSDB at the widths of ``docs/runs/musdb_synth/hparams.json`` (U16/512,
   out 256, 4 stem slots, bs8, 4 s at 8 kHz, the xla blocks in bf16, clamp
   30): a synthetic corpus of 8 train and 8 test tracks of 30 s; the init's
   loss on the first batch for seeds 0-7 (the clamp sits inside their
   spread); one ``sudo-torch-train --train MUSDB --val MUSDB`` epoch of 8
   steps at ``--seed 1`` (losses, val SI-SDRi, the epoch's times, bytes
   copied a step, peak, 0 K1 launches), an fp32 rerun and a bf16-upload run
   (half the bytes; the first two steps, the mean loss and val SI-SDRi
   within rtol = atol = 0.05; every step's gap printed beside the rerun's);
   one step card vs CPU at the checkpoint and the bf16 step's time and
   profile; the test split packed into shards (bit-identical items, ms an
   item, the same step losses through a ``device_put_fn`` loader);
   ``sudo-torch-separate --num_sources 4`` of a 30 s track (16 K1 launches
   a batch, the kernel forward >= 80 dB from ``fma``, each stem's SI-SDRi);
   a preprocessed folder of the port's ``prep`` read without joblib.
19. Exact long-form separation (``inference/sequence_parallel.py``): one
   10-minute 8 kHz mixture made from ``--seed`` through
   ``SequenceParallelSeparator`` for Improved and GroupComm U16/512 (seeded
   weights): the one-rank K1 route in fp32 and in bf16 (16 K1 launches a
   pass each), the one-rank plain shard body, ``LocalShards(2)`` and
   ``LocalShards(8)``, and the shard body over a one-rank NCCL group
   (``DistributedShards``, 0 K1 launches each); every run >= 80 dB from the
   unsharded ``fma`` / ``fma_merged`` forward of the same padded signal (the
   bf16 route >= 35 dB from that forward in bf16, which computes its blocks
   in bf16 where K1 computes in fp32), with its seconds, peak memory and
   launches. K1 at that pass's block shape (1, 256, 512, 480000,
   5) against ``uconv_block_reference`` (>= 80 dB on the block's change),
   its time, bound and yardstick; ``sudo-torch-separate --mode
   seq_parallel`` of a 60 s wav within 1 LSB of the Python API.
20. Data and tensor parallelism over ``torch.distributed`` ranks at
   U16/512 (``parallel/``), cuDNN deterministic: (a) one NCCL rank's DP
   ``Trainer`` for 3 ``xla`` fp32 bs4 steps against the plain trainer with
   the same draws (every param, the largest relative difference); two ranks
   sharing the card over gloo (NCCL refuses two ranks on one device): (b) a
   DP step (2 rows a rank) and a (data 1, model 2) step with storage and
   compute TP under ``fma``, each against the one-process step (loss, grad
   norm, params in dB), with each rank's step ms, the collectives' share of
   it (``torch.profiler``) and its peak memory; (c) DP overlap-add of a
   seeded 60 s mixture through K1 against the unsharded separator, K1
   launches a rank; (d) ``sudo-torch-separate --mode seq_parallel`` over
   the two ranks against the one-rank CLI (int16, 1 LSB); (e)
   ``sudo-torch-train --n_model 2`` over the two ranks for one epoch,
   rank 0's checkpoint loaded into a one-process model.
21. The published recipes as written (``resident``): (a)
   ``docs/runs/musdb_synth/hparams.json`` through ``sudo-torch-train``, every
   key the flag of its name (``block_impl auto``, ``chain_steps 25``,
   ``max_inflight 2``, ``device_data``, bf16, 4 stem slots, bs8), on the
   MUSDB corpus cut with n_train 400 (an epoch of 50 steps) at ``--seed 1``:
   the autotune table and pick, the device pool's MiB, 0 bytes copied from
   the host a step, the epoch, the profiled resident epoch's ms a step and
   idle share, val SI-SDRi, 0 K1 launches; its checkpoint separating a 30 s
   track through K1 (16 launches a batch, >= 80 dB from ``fma``). (b) The
   same epoch on host batches with the pick, chained (25, 2 in flight) and
   one step a dispatch, under cuDNN's deterministic algorithms: the step
   losses equal bit for bit; each run's ms a step, copies a step and idle
   share. (c) ``docs/runs/improved_u16_synth_full/hparams.json`` on the
   AUGMENTED corpus cut: the val set mixed on the card from its draws within
   rtol 1e-4 / atol 2e-5 of the host loader's items, one 50-step resident
   epoch's ms a step and idle share. (d) The native wav reader built; the
   header-only ``length_metadata`` of the MUSDB corpus against the decoding
   one, a 4-stem ``read_wav_window`` item against scipy's.
22. The port's tools (``tools``), each through its ``main(argv)`` with
   K1's counts at 0 before it: ``scripts/torch_bench_batch_sweep.py`` at
   bs 8 and 32 over its six paths, ``torch_bench_gc_serving.py
   --families_sweep`` at bs4, ``torch_bench_quantized.py`` on
   ``u36_2048`` and ``u36_wide`` at bs4 (``--attribute`` on the wide one),
   ``torch_roofline_bound.py --measure``, ``torch_longform_run.py`` on 2
   minutes of the resident phase's AUGMENTED test split from its
   checkpoint, and ``examples/torch_quickstart.py``: every promised key
   present and finite, K1 once a block a forward on each ``kernel`` row,
   ``kernel`` rows >= 80 dB from the plain or ``fma`` forward, bf16 rows
   >= 35 dB from fp32, the gated GroupComm int8 recipe (where one passes)
   >= 25 dB, each roofline time above its floor.
23. Print JSON lines of the serving, training, evaluation, recipe,
   augmented, reduced-precision, bench, causal, zoo, baseline, MUSDB,
   long-form, parallel, resident and tools results, each phase's seconds,
   and one line of
   kernel results (K1 with an fp32 and with a bf16 pyramid; the first with
   the AUGMENTED evaluation's, the MUSDB separation's, the long-form passes'
   and the DP overlap-add's launches, K1's time at the long-form block
   shape, and its 0 launches on the causal, v1, attentive, baseline, MUSDB,
   DP and TP training paths and the n-shard bodies, and the resident
   phase's training paths and separation, each tool's launches and K1 at
   the u36_wide block), then
   ``{"ok": true, "device": ...}`` as the last line. Any failure raises and
   exits non-zero. ``--only PHASE ...`` runs some phases (a rehearsal on
   the card, without the kernels and ok lines).
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

FS = 8000
CHUNK_SECONDS = 4.0
BATCH = 4
FLAGSHIP = dict(out_channels=256, in_channels=512, num_blocks=16,
                upsampling_depth=5, enc_kernel_size=21, enc_num_basis=512,
                num_sources=2)
# the GroupComm SuDoRM-RF v2 operating point of scripts/bench_gc_serving.py
# (565,073 params)
GROUPCOMM = dict(FLAGSHIP, group_size=16)
# B, Co, Ci, T, depth: the flagship block at batch 1, 4 and 8; a ragged one;
# one with T % 4 != 0, which takes the kernel's 4-byte load paths; the
# GroupComm block at bs4 with its 16 groups folded into the batch; the U36
# block; and the U8/256 block of scripts/torch_port_convergence.py's
# validation (bs4, 2 s)
GC_BLOCK = (BATCH * GROUPCOMM["group_size"], 256 // 16, 512 // 16, 3200, 5)
# the published Improved SuDoRM-RF U36/Bases4096 WHAMR! configuration
# (sudo_rm_rf_tpu/utils/benchmark.py zoo row sudormrf_R36_B4096), served on
# 4 s crops at 16 kHz: its blocks run at (B, 512, 512, 6400, 5)
U36 = dict(out_channels=512, in_channels=512, num_blocks=36, upsampling_depth=5,
           enc_kernel_size=21, enc_num_basis=4096, num_sources=2)
FS16 = 16000
U36_BLOCK = (BATCH, 512, 512, 6400, 5)
CONVERGENCE_BLOCK = (BATCH, 128, 256, 1600, 5)
# the u36_wide configuration of scripts/bench_quantized.py (out 512, in 2048,
# 36 blocks, 2048 bases) at 8 kHz, 4 s: its blocks run at (B, 512, 2048,
# 3200, 5), checked at B=1 and 4
U36_WIDE_BLOCK = (512, 2048, 3200, 5)
WIDE_BATCHES = (1, BATCH)
BLOCK_SHAPES = [(1, 256, 512, 3200, 5), (4, 256, 512, 3200, 5),
                (8, 256, 512, 3200, 5), (2, 20, 36, 648, 4), (2, 70, 100, 334, 2),
                GC_BLOCK, (1, 512, 512, 6400, 5), U36_BLOCK, CONVERGENCE_BLOCK]
# the evaluation split: 16 kHz WHAMR-layout test files, two of them longer
# than the 4 s chunk (the first one is the full-length phase's)
EVAL_SECONDS = (10.0, 4.0, 4.0, 4.0, 4.5, 4.0, 4.0, 4.0)
EVAL_FULL_LENGTH_FILES = 2
MAX_SISDRI_DIFF_DB = 0.01
# the JAX package's own run configurations of the two recipes
# (docs/runs/whamr_u16_synth/hparams.json, docs/runs/fuss_u16_synth/hparams.json)
RECIPE_RUNS = {
    "WHAMR": dict(hp=dict(out_channels=256, in_channels=512, num_blocks=16,
                          upsampling_depth=5, enc_kernel_size=21, enc_num_basis=2048,
                          num_sources=2),
                  fs=8000, loss_clamp=50.0, mixture_consistency=None,
                  argv=["--separation_task", "noisy_reverberant"]),
    "FUSS": dict(hp=dict(out_channels=128, in_channels=512, num_blocks=16,
                         upsampling_depth=5, enc_kernel_size=21, enc_num_basis=512,
                         num_sources=4),
                 fs=16000, loss_clamp=0.0, mixture_consistency="uniform",
                 argv=["--max_num_sources", "4"]),
}
RECIPE_BATCH, RECIPE_STEP_REPS = 8, 3
WAV_SECONDS = (3.0, 10.0, 25.0)
MIN_FIDELITY_DB = 80.0
K1_PARTS = ("split", "gemm", "ladder", "fold", "upsum")
TRAIN_FILES, VAL_FILES = 16, 8
TRAIN_EPOCHS = 2
# the timed train steps of a configuration (10 before the tools phase was added)
STEP_WARMUP, STEP_REPS = 3, 3
MAX_CARD_CPU_REL = 1e-3
HP_FLAGS = ("out_channels", "in_channels", "num_blocks", "upsampling_depth",
            "enc_kernel_size", "enc_num_basis", "group_size")
# K1 with a bf16 pyramid: the shapes, and its limits against its plain
# version on the block's change (out - x): >= 80 dB, |delta| <= 2e-3 but at
# bf16 rounding flips. Where the two round a stored level value to
# neighbouring bf16 values, one output moves by up to ~5e-3 (a bf16 spacing,
# 2^-7 of a normalized value of ~4, times a res weight of up to ~0.15); the
# plain version in fp32 and in float64 part so by 2.7e-3 to 4.8e-3 at these
# shapes. So at most 1e-5 of the outputs may pass 2e-3, and none 1e-2; a
# fault of the kernel's indexing or statistics moves whole rows or planes.
PYRAMID_SHAPES = [(BATCH, 256, 512, 3200, 5), GC_BLOCK, U36_BLOCK]
PYRAMID_MIN_DB, PYRAMID_MAX_ABS = 80.0, 2e-3
PYRAMID_FLIP_SHARE, PYRAMID_FLIP_MAX = 1e-5, 1e-2
F64_SHAPES = [(BATCH, 256, 512, 3200, 5), U36_BLOCK]
# K1's max |err| and rms against float64 at F64_SHAPES on the tree before
# the wide GEMM (PERF.md section 6: its outputs there are bit for bit those
# of the narrow GEMM); the check holds K1 within 1.25x of them
K1_F64_BEFORE = {"K=256": dict(max_abs=1.936e-06, rms=2.643e-07),
                 "K=512": dict(max_abs=4.882e-06, rms=2.971e-07)}
K1_F64_SLACK = 1.25
# the AUGMENTED phase: docs/runs/improved_u16_synth/hparams.json (Improved
# U16/512 at out 256, bs8, 4 s at 8 kHz, Adam 1e-3, clip 5, clamp 30, the
# xla blocks in bf16) on a hierarchical corpus cut from 50 x 60 train and
# 10 x 20 val and test utterances, 20000 / 3000 / 3000 mixtures
AUGMENTED_CUT = dict(train_speakers=12, utts=8, val_speakers=4, test_speakers=4, val_utts=6,
                     n_train=64, n_eval=16, batch_size=8, seconds=4.0)
AUGMENTED_TRAIN_ARGV = ("--block_impl", "xla", "--compute_dtype", "bfloat16")
# the MUSDB phase: docs/runs/musdb_synth/hparams.json (Improved U16/512 at
# out 256 with 4 stem slots, bs8, 4 s at 8 kHz, Adam 1e-3, clip 5, clamp 30,
# stepped decay at patience 10, bf16) with the xla blocks (what JAX's
# auto-tuner picked for that run), on host batches; the resident phase runs
# the recipe as written.
# The synthetic corpus of 30 s tracks is cut from 60 train and 12 test tracks
# to 8 and 8 (a val batch of 8 needs 8 tracks: one segment a track, and the
# loader drops a partial batch), n_train 2000 -> 64, n_val 24 -> 8. The
# bf16-upload run's losses must stay within JAX's own bounds of the fp32
# upload's (tests/test_trainer.py:414-440), which JAX's test applies to two
# steps: here to the first two steps, the epoch's mean loss and its val
# SI-SDRi. Step by step the two runs part further (the rounded batch moves
# each update, and training amplifies it), so every step's gap is printed
# beside that of an fp32 rerun, the card's own run-to-run spread.
MUSDB = dict(FLAGSHIP, num_sources=4)
MUSDB_CUT = dict(train_tracks=8, test_tracks=8, track_seconds=30.0, n_train=64, n_val=8,
                 batch_size=8, seconds=4.0)
MUSDB_TRAIN_ARGV = ("--block_impl", "xla", "--compute_dtype", "bfloat16", "-lr", "1e-3",
                    "--clip_grad_norm", "5", "--patience", "10")
MUSDB_LOSS_CLAMP = 30.0
MUSDB_SEED = 1
MUSDB_PROBE_SEEDS = 8
UPLOAD_RTOL = UPLOAD_ATOL = 0.05
MUSDB_CPU_BATCH = 2
# the resident phase: docs/runs/musdb_synth/hparams.json as written (block_impl
# auto, chain_steps 25, max_inflight 2, device_data, bf16, 4 stem slots, bs8)
# on the MUSDB phase's corpus cut, with n_train 2000 -> 400 (an epoch of 50
# steps), n_val and n_test 24 -> 8, one epoch, at --seed 1 (MUSDB_SEED); then
# the same epoch on host batches, chained and one step a dispatch; and
# docs/runs/improved_u16_synth_full/hparams.json on the AUGMENTED phase's
# corpus cut, n_train 20000 -> 400, n_val and n_test 3000 -> 16. The keys
# the CLI derives from others are not flags (RESIDENT_DERIVED); every other
# key is the flag of its name or of RESIDENT_FLAGS.
RESIDENT_HPARAMS = ("docs", "runs", "musdb_synth", "hparams.json")
RESIDENT_AUG_HPARAMS = ("docs", "runs", "improved_u16_synth_full", "hparams.json")
RESIDENT_CUT = dict(MUSDB_CUT, n_train=400)
RESIDENT_AUG_CUT = dict(AUGMENTED_CUT, n_train=400)
RESIDENT_FLAGS = {"learning_rate": "-lr", "patience_epochs": "--patience", "batch_size": "-bs",
                  "fs": "-fs", "n_heads": "--att_n_heads", "checkpoints_path": "-clp"}
RESIDENT_DERIVED = ("num_sources", "in_audio_channels", "scan_blocks")
HOST_LOADER_TOL = dict(rtol=1e-4, atol=2e-5)  # JAX's, tests/test_resident.py
RESIDENT_PROFILED = 10  # the last train steps of an epoch traced for its idle share
RESIDENT_IO_REPS = 20
# reduced-precision serving: the bench's gates (bench.py) and the batches
# timed; an int8 output under INT8_MIN_DB is a fault, not a miss of the gate
BF16_GATE_DB, INT8_GATE_DB, INT8_MIN_DB = 35.0, 25.0, 15.0
SERVE_BATCHES = (BATCH, 8)
# the headline bench's timed calls a row (its default, 21, took 56 s of the
# bench phase, most in its autotuned train rows; chip_smoke checks its line
# and gates, the bench itself measures)
HEADLINE_REPS = 3
# the rest of the SuDoRM-RF family, at full width (8 kHz, 4 s, bs4): causal
# v3 at the JAX class defaults (sudo_rm_rf_tpu/models/causal_sudormrf.py:
# 141-150), its skip-init gains set to CAUSAL_GAIN (at 0, as drawn, every
# block passes its input through); v1 at the JAX class defaults (sudormrf.py:
# 203-212, the MLSP 2020 paper's 1.0x model); attentive v1-v3 at the JAX zoo
# rows attentive_v2/v3 (utils/benchmark.py:327-336), v1 with the config's
# 4 heads, 256 dims and dropout 0.1 (v2 and v3 hardcode them)
CAUSAL = dict(in_audio_channels=1, out_channels=128, in_channels=512, num_blocks=16,
              upsampling_depth=4, enc_kernel_size=21, enc_num_basis=512, num_sources=2)
CAUSAL_GAIN = 0.2
V1 = dict(out_channels=128, in_channels=512, num_blocks=16, upsampling_depth=4,
          enc_kernel_size=21, enc_num_basis=512, num_sources=2)
ATTENTIVE = dict(out_channels=256, in_channels=512, num_blocks=16, upsampling_depth=5,
                 enc_kernel_size=21, enc_num_basis=512, num_sources=2)
ZOO = {"softmax": V1, "attention": ATTENTIVE, "attention_v2": ATTENTIVE,
       "attention_v3": ATTENTIVE}
# scripts/bench_streaming.py:33-38: a 20 ms hop, 400 ms of left context, the
# granule (160) as lookahead, 1 and 16 concurrent streams
STREAM_HOP, STREAM_CONTEXT, STREAM_COUNTS = 160, 3200, (1, 16)
# streamed against offline: a context that covers the causal U16 model's
# reach into the past (16 blocks x 10 taps x (1 + 2 + 4 + 8) frames x 10
# samples + the encoder's 200 = 24,200 samples), over a 4 s stream compared
# past that head
STREAM_CHECK_CONTEXT = 25600
ZOO_STEP_REPS = 3
# the baselines at their class defaults, the published configurations
# (ConvTasNet 5.05 M params, DPRNN 2.63 M, Demucs 415.09 M, TDCN 8.63 M,
# ResidualTN 9.42 M, SepFormer 25.68 M), and the JAX zoo's baseline rows
BASELINES = dict.fromkeys(("convtasnet", "dprnn", "demucs", "tdcn", "residual_tdcn",
                           "sepformer"), {})
BASELINE_BENCH = ("convtasnet", "dprnn", "demucs", "tdcn", "sepformer")
# sudo-torch-train --optimizer radam_cosine keeps the JAX trainer's warmup
# of 1000 updates, and its cosine decay needs total_steps = n_epochs x
# steps_per_epoch past it: one epoch of 1001 files at batch 1. The synthetic
# voices are gated, so a short file can hold a silent source, whose SI-SDR
# is NaN: at 1.5 s and seed 0 none of the 1001 + 4 files has one (at 0.5 s,
# 81 of 2002 train sources are silent). The model is Improved U16/512's
# widths cut in depth to one block: a U16/512 `fma` step at bs1 is host
# bound at ~260 ms, so its 2,002 steps took 530 s of the phase's 630.
RADAM_FILES, RADAM_SECONDS, RADAM_SEED = 1001, 1.5, 0
RADAM_HP = dict(FLAGSHIP, num_blocks=1)
# exact long-form separation: a 10-minute 8 kHz recording in one pass
# (4,800,000 samples; the one-rank K1 route runs K1 at (1, 256, 512, 480000,
# 5)), the shard counts of the n-shard body run on one card, and the CLI's
# wav
LONGFORM_SECONDS = 600.0
LONGFORM_SHARDS = (2, 8)
LONGFORM_CLI_SECONDS = 60.0
LONGFORM_BLOCK = (1, 256, 512, int(LONGFORM_SECONDS * FS) // 10, 5)
# every layout the ladder's chooser (csrc/uconv.cu ladder_work) picks: the
# flagship block at the serving cell's bs32 (16,384 rows, a tile a row); the
# U36 block at bs4 and GroupComm's folded shape (2,048 rows, two tiles a
# row); a ragged T whose two deepest levels (402 and 201 outputs) take the
# 4-byte paths; the 10-minute block (rows cut into 30 tiles at level 0)
LADDER_SHAPES = [(32, 256, 512, 3200, 5), U36_BLOCK, GC_BLOCK, (8, 256, 512, 3216, 5),
                 LONGFORM_BLOCK]
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12  # the fp32 pipes, outside the tensor cores
# (B, G, n, T) of TAC's kernel checks: the gc-u16-batch32 cell's TAC, the
# 10-minute pass's (7,500 tiles a plane: the fold launch), narrow and wide
# groups with T past a whole tile and odd; the first two are timed
TAC_SHAPES = [(32, 16, 16, 3200), (1, 16, 16, int(LONGFORM_SECONDS * FS) // 10), (3, 8, 4, 1037),
              (2, 4, 8, 777), (2, 8, 32, 1001)]
TAC_TIMED = TAC_SHAPES[:2]


def time_ms(torch, fn, warmup: int = 3, reps: int = 25) -> float:
    """Median device time of one call, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms_by_kernel(torch, fn, calls: int, by_part: bool = True,
                        launches: dict | None = None) -> dict:
    """Device time per call of fn, summed by K1 part (``<part>_kernel``) and
    "other", or by kernel name, from the raw device events of a
    ``torch.profiler`` trace (``key_averages`` took 7-20 s a call over a
    train step); empty if the trace holds no device time. ``launches``, if
    given, gets the device launches per call under the same names."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.duration_ns() <= 0:
            continue
        m = re.search(r"\b(%s)_kernel\b" % "|".join(K1_PARTS), e.name())
        name = (m.group(1) if m else "other") if by_part else e.name()
        out[name] = out.get(name, 0.0) + e.duration_ns() / 1e6 / calls
        if launches is not None:
            launches[name] = launches.get(name, 0.0) + 1 / calls
    return out


def ladder_level_ms(torch, fn, depth: int, calls: int) -> tuple:
    """(device ms a call of each ladder level, ``fold_kernel`` launches a
    call) of fn, from the raw device events of a ``torch.profiler`` trace:
    the ``ladder_kernel`` launches in the order they ran, level k the k-th
    of each call; (None, None) where the trace does not hold depth of them
    a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = sorted((e.start_ns(), e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0)
    ladders = [ns for _, ns, name in events if re.search(r"\bladder_kernel\b", name)]
    folds = sum(1 for *_, name in events if re.search(r"\bfold_kernel\b", name))
    if len(ladders) != depth * calls:
        return None, None
    return [sum(ladders[k::depth]) / 1e6 / calls for k in range(depth)], folds / calls


def tensor_core_instructions(lib) -> int | None:
    """HGMMA/HMMA instructions in the SASS of the GEMM kernels of the built
    library, or None where ``cuobjdump`` is absent."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    count, function = 0, ""
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            function = m.group(1)
        elif "gemm_kernel" in function and re.search(r"\bH(G)?MMA\b", line):
            count += 1
    return count


def block_params(torch, depth, ci, co, seed):
    """Seeded U-ConvBlock params in the kernel's dict layout, on the card."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    u = lambda *s: 0.5 + torch.rand(*s, generator=g)
    p = dict(
        proj_w=r(ci, co) * co**-0.5, proj_b=r(ci) * 0.1, proj_g=u(ci),
        proj_beta=r(ci) * 0.1, proj_slope=torch.tensor(0.25),
        dw_w=r(depth, ci, 5) * 0.3, dw_b=r(depth, ci) * 0.1, dw_g=u(depth, ci),
        dw_beta=r(depth, ci) * 0.1, final_g=u(ci), final_beta=r(ci) * 0.1,
        final_slope=torch.tensor(0.25), res_w=r(co, ci) * ci**-0.5,
        res_b=r(co) * 0.1,
    )
    return {k: v.cuda() for k, v in p.items()}


def n_forward_batches(n_samples: int, chunk: int, batch: int) -> int:
    """Forward batches OverlapAddSeparator runs for one recording."""
    if n_samples <= chunk:
        return 1
    n_chunks = -(-(n_samples - chunk) // (chunk // 2)) + 1
    return -(-n_chunks // batch)


def fidelity_db(np, ref, est) -> float:
    err = float(((ref - est) ** 2).sum())
    return float("inf") if err == 0.0 else 10 * np.log10(float((ref**2).sum()) / err)


class _Tee(io.TextIOBase):
    """Writes through to a stream and keeps a copy of what it wrote."""

    def __init__(self, stream):
        self.stream, self.copy = stream, io.StringIO()

    def write(self, s):
        self.stream.write(s)
        return self.copy.write(s)

    def flush(self):
        self.stream.flush()


def run_cli(main_fn, argv) -> str:
    """Run a CLI's ``main(argv)``, showing and returning its standard output."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = main_fn(argv)
    if rc != 0:
        raise RuntimeError(f"{main_fn.__module__} returned {rc}")
    return tee.copy.getvalue()


def hp_argv(hp: dict) -> list:
    return [a for key in HP_FLAGS if key in hp for a in (f"--{key}", str(hp[key]))]


def checkpoint_weights(model_type: str, hp: dict, path: str) -> dict:
    """The state_dict held by a msgpack checkpoint of ``sudo-torch-train``."""
    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.convert import load_model_from_checkpoint

    model = models.get_model(model_type, **hp, device="cpu")
    return load_model_from_checkpoint(path, model).state_dict()


def checkpoint_counts(path: str) -> tuple:
    """(step, Adam's count, the schedule's count) of a msgpack TrainState."""
    from sudo_rm_rf_tpu_torch.convert.flax_checkpoint import read_checkpoint

    tree = read_checkpoint(path)
    adam, schedule = tree["opt_state"]["1"]["0"], tree["opt_state"]["1"]["1"]
    return int(tree["step"]), int(adam["count"]), int(schedule["count"])


def si_sdr_db(np, est, ref) -> float:
    est, ref = est - est.mean(), ref - ref.mean()
    proj = (est @ ref) / (ref @ ref) * ref
    return float(10 * np.log10((proj @ proj) / ((est - proj) @ (est - proj))))


def k1_phase(torch, U, lib, hmma) -> dict:
    """Phase 3: K1 against its plain version at every shape; the profiled
    rows at the flagship B=4, the GroupComm folded shape and the U36 WHAMR!
    block at B=4."""
    from sudo_rm_rf_tpu_torch.utils.benchmark import k1_bound

    rows = {}
    for b, co, ci, t, depth in BLOCK_SHAPES:
        p = block_params(torch, depth, ci, co, seed=0)
        x = torch.randn(b, co, t, generator=torch.Generator().manual_seed(1)).cuda()
        got = U.fused_uconv_block(x, p, depth)
        torch.cuda.synchronize()
        want = U.uconv_block_reference(x, p, depth)
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        print(f"K1 {(b, co, ci, t, depth)}: max_abs_err {err:.3e} "
              f"(relative to max |plain| {rel:.3e})")
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        if not torch.equal(got, U.fused_uconv_block(x, p, depth)):
            raise RuntimeError(f"K1 {(b, co, ci, t, depth)}: two calls differ")
        name = ("flagship" if (co, ci, t, depth) == (256, 512, 3200, 5)
                else "u36" if (co, ci, t, depth) == U36_BLOCK[1:]
                else "groupcomm" if (b, co, ci, t, depth) == GC_BLOCK else None)
        if name is None:
            continue
        ms = {form: time_ms(torch, lambda f=f: f(x, p, depth)) for form, f in (
            ("kernel", U.fused_uconv_block), ("fma", U.uconv_block_fma),
            ("plain", U.uconv_block_reference))}
        label = f"K1 {name} B={b}"
        print(f"{label} ms (median of 25): kernel {ms['kernel']:.4f} "
              f"fma {ms['fma']:.4f} plain {ms['plain']:.4f}")
        if name in ("flagship", "u36") and b != BATCH:
            continue  # the profiled rows are the serving paths' shapes
        bound = k1_bound(b, co, ci, t, depth)
        row = dict(shape=f"B,Co,Ci,T,depth={b},{co},{ci},{t},{depth}", max_abs_err=err,
                   ms=ms["kernel"], plain_ms=ms["plain"], fma_ms=ms["fma"],
                   bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
        call = lambda: U.fused_uconv_block(x, p, depth)
        parts = device_ms_by_kernel(torch, call, 20)
        print(f"{label} device ms per call by part (torch.profiler, 20 calls): "
              + (", ".join(f"{k} {parts[k]:.4f}" for k in K1_PARTS if k in parts)
                 or "not measured (no device time in the trace)"))
        acc_in = torch.randn(b, ci, t, generator=torch.Generator().manual_seed(2)).cuda()
        two = lambda: (torch.matmul(p["proj_w"], x), torch.matmul(p["res_w"], acc_in))
        lib_ms = time_ms(torch, two)
        torch.backends.cuda.matmul.allow_tf32 = True
        lib_tf32_ms = time_ms(torch, two)
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"{label} yardstick, torch.matmul of the same two products: fp32 "
              f"{lib_ms:.4f} ms, TF32 (one pass, ~3 digits) {lib_tf32_ms:.4f} ms")
        print(f"{label} bound {bound['bound_ms']:.4f} ms (3xTF32 tensor cores, "
              f"{bound['bound_by']}; share {bound['bound_ms'] / ms['kernel']:.1%}), "
              f"{bound['bound_fp32_simt_ms']:.4f} ms on the fp32 pipes (share "
              f"{bound['bound_fp32_simt_ms'] / ms['kernel']:.1%})")
        # the device memory one call allocates (its output and K1's scratch),
        # read from the caching allocator; beside it, the scratch the shapes
        # call for: the pyramid, the proj output, folds, partials, W's split
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        call()
        torch.cuda.synchronize()
        call_mb = (torch.cuda.max_memory_allocated() - before) / 1e6
        ws = 4 * lib.uconv_workspace_floats(b, co, ci, t, depth, 0) / 1e6
        pyr = 4 * b * ci * sum(t >> k for k in range(depth)) / 1e6
        print(f"{label} one call allocates {call_mb:.1f} MB on the card (measured: output "
              f"{4 * x.numel() / 1e6:.1f} MB + scratch); the shapes call for a scratch of "
              f"{ws:.1f} MB, of it the pyramid {pyr:.1f} MB")
        row.update(library_ms=lib_ms, library_tf32_ms=lib_tf32_ms,
                   library_call="torch.matmul of the proj and res products",
                   parts_ms={k: parts.get(k) for k in K1_PARTS},
                   call_alloc_mb=call_mb, bit_identical=True,
                   tensor_core_instructions=hmma)
        rows[name] = row
    return rows


def serve_phase(torch, np, tmp: str, model_type: str, hp: dict, extra_argv=(),
                device: str = "cuda") -> dict:
    """Phases 4 and 5: serve a seeded checkpoint through
    ``sudo-torch-separate`` (K1 launches counted from 0), one file again
    through the plain blocks, then one bs4 forward: fidelity, the time of
    each impl and the kernel forward's device time by kernel."""
    from scipy.io import wavfile

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.cli.separate import main as separate_main
    from sudo_rm_rf_tpu_torch.data.base import read_wav
    from sudo_rm_rf_tpu_torch.inference import separate_file
    from sudo_rm_rf_tpu_torch.models import fast_inference as fi
    from sudo_rm_rf_tpu_torch.ops import uconv as U
    from sudo_rm_rf_tpu_torch.ops.tac import fused_tac

    gc = model_type == "groupcomm_v2"
    forward = fi.groupcomm_forward_fast if gc else fi.improved_forward_fast
    impls = fi.GC_IMPLS if gc else ("kernel", "fma", "xla")
    mc = "uniform" if gc else None
    tag = "GC U16/512" if gc else "U16/512"
    chunk = int(CHUNK_SECONDS * FS)
    rng = np.random.default_rng(0)
    model = models.get_model(model_type, **hp, device=device,
                             generator=torch.Generator().manual_seed(0))
    model.eval()
    ckpt = os.path.join(tmp, f"{model_type}.pt")
    torch.save(model.state_dict(), ckpt)
    wavs, batches = [], 0
    for sec in WAV_SECONDS:
        n = int(sec * FS)
        tt = np.arange(n) / FS
        mix = (0.3 * np.sin(2 * np.pi * 220 * tt) + 0.2 * np.sin(2 * np.pi * 1330 * tt)
               + 0.05 * rng.standard_normal(n))
        path = os.path.join(tmp, f"mix_{int(sec)}s.wav")
        wavfile.write(path, FS, (mix * 32767).astype(np.int16))
        wavs.append((path, n))
        batches += n_forward_batches(n, chunk, BATCH)
    out_dir = os.path.join(tmp, f"separated_{model_type}")
    argv = ["--checkpoint", ckpt, "--model_type", model_type, "--input",
            *(w for w, _ in wavs), "--out_dir", out_dir, "--device", device,
            "--batch_chunks", str(BATCH), "-fs", str(FS),
            "--chunk_seconds", str(CHUNK_SECONDS), *hp_argv(hp), *extra_argv]
    # the serving path, with the kernel counts at 0 just before it
    U.fused_uconv_block.launches = fused_tac.launches = 0
    t0 = time.perf_counter()
    if separate_main(argv) != 0:
        raise RuntimeError("sudo-torch-separate returned non-zero")
    if device == "cuda":
        torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches, tac_launches = U.fused_uconv_block.launches, fused_tac.launches
    want = hp["num_blocks"] * batches if device == "cuda" else 0
    print(f"CLI {model_type}: {len(wavs)} files, {batches} forward batches, "
          f"{launches} kernel launches, {tac_launches} TAC kernel launches, {cli_s:.2f} s")
    if launches != want or tac_launches != 2 * want * gc:
        raise RuntimeError(f"expected {want} kernel launches and {2 * want * gc} TAC kernel "
                           f"launches, counted {launches} and {tac_launches}")
    for path, n in wavs:
        stem = os.path.splitext(os.path.basename(path))[0]
        for s in (1, 2):
            sr, est = read_wav(os.path.join(out_dir, f"{stem}_s{s}.wav"))
            if sr != FS or est.shape != (n,) or not np.isfinite(est).all():
                raise RuntimeError(f"{stem}_s{s}: sr {sr} shape {est.shape}")
            if not np.abs(est).max() > 0:
                raise RuntimeError(f"{stem}_s{s} is silent")
    # one file again, through the plain blocks: the int16 outputs agree
    plain_dir = os.path.join(tmp, f"plain_{model_type}")
    separate_file(model, wavs[1][0], plain_dir, fs=FS, chunk_seconds=CHUNK_SECONDS,
                  batch_chunks=BATCH, mixture_consistency=mc,
                  forward_fn=functools.partial(forward, model, impl="xla"))
    stem = os.path.splitext(os.path.basename(wavs[1][0]))[0]
    lsbs = []
    for s in (1, 2):
        a = wavfile.read(os.path.join(out_dir, f"{stem}_s{s}.wav"))[1].astype(np.int32)
        c = wavfile.read(os.path.join(plain_dir, f"{stem}_s{s}.wav"))[1].astype(np.int32)
        lsbs.append(int(np.abs(a - c).max()))
        print(f"CLI {model_type} {stem}_s{s}: kernel vs plain blocks max diff {lsbs[-1]} LSB")
        if lsbs[-1] > 1:
            raise RuntimeError(f"{stem}_s{s}: kernel and plain outputs differ by {lsbs[-1]} LSB")

    # fidelity and speed of one bs4 4 s forward
    n_out = 2 * hp.get("in_audio_channels", 1)
    x = torch.from_numpy(rng.standard_normal((BATCH, 1, chunk)).astype(np.float32)).to(device)
    U.fused_uconv_block.launches = 0
    ker = forward(model, x, impl="kernel")
    per_forward = U.fused_uconv_block.launches
    print(f"{tag} bs{BATCH} kernel forward: {per_forward} K1 launches (counted)")
    if per_forward != (hp["num_blocks"] if device == "cuda" else 0):
        raise RuntimeError(f"one kernel forward launched K1 {per_forward} times")
    ref = forward(model, x, impl="xla")
    if ker.shape != (BATCH, n_out, chunk) or not torch.isfinite(ker).all():
        raise RuntimeError(f"bad forward output {tuple(ker.shape)}")
    fid = fidelity_db(np, ref.double().cpu().numpy(), ker.double().cpu().numpy())
    print(f"{tag} bs{BATCH} fp32 forward fidelity kernel vs xla: {fid:.2f} dB")
    if not fid >= MIN_FIDELITY_DB:
        raise RuntimeError(f"fidelity {fid:.2f} dB < {MIN_FIDELITY_DB} dB")
    out = dict(launches=launches, tac_launches=tac_launches, forward_batches=batches,
               launches_per_forward=per_forward,
               cli_s=cli_s, cli_vs_plain_lsb=max(lsbs), fidelity_db=fid)
    if device != "cuda":
        return out
    audio_s = BATCH * CHUNK_SECONDS
    fwd = {}
    for impl in impls:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(torch, lambda i=impl: forward(model, x, impl=i), reps=20)
        peak = torch.cuda.max_memory_allocated() / 2**20
        fwd[impl] = dict(ms=ms, audio_s_per_s=audio_s / (ms / 1e3), peak_mib=peak)
        print(f"{tag} bs{BATCH} fp32 forward impl={impl}: {ms:.3f} ms, "
              f"{audio_s / (ms / 1e3):.1f} audio-s/s, peak {peak:.0f} MiB")
    counts = {}
    by_kernel = device_ms_by_kernel(
        torch, lambda: forward(model, x, impl="kernel"), 5, launches=counts)
    busy = sum(by_kernel.values())
    print(f"{tag} bs{BATCH} kernel forward device ms by kernel (torch.profiler, 5 "
          f"forwards): " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(by_kernel.items()))
          + f"; busy {busy:.3f} of {fwd['kernel']['ms']:.3f} ms, idle "
          f"{1 - busy / fwd['kernel']['ms']:.1%}; device launches a forward "
          f"{sum(counts.values()):.0f}")
    # "other" (everything outside K1) by kernel name
    named_counts = {}
    named = device_ms_by_kernel(torch, lambda: forward(model, x, impl="kernel"), 5,
                                by_part=False, launches=named_counts)
    top = sorted(((k, v) for k, v in named.items()
                  if not re.search(r"\b(%s)_kernel\b" % "|".join(K1_PARTS), k)),
                 key=lambda kv: -kv[1])[:8]
    print(f"{tag} bs{BATCH} kernel forward, top 8 kernels outside K1 by device ms a "
          f"forward (launches): " + "; ".join(
              f"{k[:70]} {v:.3f} ({named_counts[k]:.0f})" for k, v in top))
    out.update(forward=fwd, kernel_forward_device_ms=by_kernel, busy_ms=busy,
               idle_share=1 - busy / fwd["kernel"]["ms"],
               device_launches=sum(counts.values()),
               top_other_kernels_ms={k[:80]: v for k, v in top})
    return out


def step_checks(torch, np, model_type: str, hp: dict, weights: dict, batch, device: str,
                variants, reps: int = STEP_REPS, recipe=None, label: str = "U16/512",
                cpu_batch=None, **trainer_cfg) -> dict:
    """One step of ``weights`` on the card and on the CPU from the same
    batch and draws (loss and grad norm within MAX_CARD_CPU_REL), then the
    median step time, peak memory and profile of each (block_impl,
    compute_dtype) in ``variants``. ``recipe`` (``train.experiment.Recipe``)
    gives the draws, batch preparation and loss; by default the WHAM remix
    of a (B, 2, T) source batch. ``cpu_batch`` (default ``batch``) is the
    batch of the card-vs-CPU step."""
    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig, draw_remix

    tag = "GC " if model_type == "groupcomm_v2" else ""
    bs = (batch[0] if isinstance(batch, tuple) else batch).shape[0]
    draw = recipe.draw if recipe else (lambda g, _: draw_remix(g, bs, 2))
    fns = dict(loss_fn=recipe.loss_fn, prepare_batch=recipe.prepare) if recipe else {}
    cpu_batch = batch if cpu_batch is None else cpu_batch
    draws = draw(torch.Generator().manual_seed(7), cpu_batch)
    metrics = {}
    for dev in (device, "cpu"):
        model = models.get_model(model_type, **hp, block_impl="fma", device=dev)
        model.load_state_dict(weights)
        tr = Trainer(model, TrainerConfig(**trainer_cfg), **fns)
        _, m = tr.train_step(tr.init_state(), cpu_batch, draws)
        metrics[dev] = {k: float(v) for k, v in m.items()}
        del model, tr
    rel = {k: abs(metrics[device][k] - metrics["cpu"][k]) / abs(metrics["cpu"][k])
           for k in ("loss", "grad_norm")}
    print(f"{tag}{label} one step card vs CPU: loss {metrics[device]['loss']:.6f} vs "
          f"{metrics['cpu']['loss']:.6f} (rel {rel['loss']:.2e}), grad norm "
          f"{metrics[device]['grad_norm']:.6f} vs {metrics['cpu']['grad_norm']:.6f} "
          f"(rel {rel['grad_norm']:.2e})")
    clamp = TrainerConfig(**trainer_cfg).loss_clamp
    if clamp > 0 and abs(metrics["cpu"]["loss"]) >= clamp:
        raise RuntimeError("the loss clamp saturated: the comparison would be vacuous")
    if max(rel.values()) > MAX_CARD_CPU_REL:
        raise RuntimeError(f"card and CPU steps differ by {rel}")

    # step times, on a batch resident on the card
    steps = {}
    if device == "cuda":
        on_card = (tuple(torch.from_numpy(x).to(device) for x in batch)
                   if isinstance(batch, tuple) else torch.from_numpy(batch).to(device))
        audio_s = bs * CHUNK_SECONDS
        for impl, dtype in variants:
            model = models.get_model(model_type, **hp, block_impl=impl, device=device)
            model.load_state_dict(weights)
            tr = Trainer(model, TrainerConfig(compute_dtype=dtype, **trainer_cfg), **fns)
            state, gen = tr.init_state(), torch.Generator().manual_seed(0)
            step = lambda: tr.train_step(state, on_card, draw(gen, batch))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(torch, step, warmup=STEP_WARMUP, reps=reps)
            peak = torch.cuda.max_memory_allocated() / 2**20
            name = f"{impl} {dtype or 'float32'}"
            row = dict(ms=ms, audio_s_per_s=audio_s / (ms / 1e3), peak_mib=peak)
            counts = {}
            by_name = device_ms_by_kernel(torch, step, 3, by_part=False, launches=counts)
            busy = sum(by_name.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            row.update(device_busy_ms=busy, idle_share=1 - busy / ms,
                       device_launches=sum(counts.values()),
                       top_kernels_ms={k[:80]: v for k, v in top})
            steps[name] = row
            print(f"{tag}train step {tag}{label} bs{bs} {name}: {ms:.3f} ms (median of "
                  f"{reps}), {row['audio_s_per_s']:.1f} audio-s/s, peak {peak:.0f} MiB; "
                  f"torch.profiler over 3 steps: device busy {busy:.3f} ms, idle "
                  f"{row['idle_share']:.1%}, {row['device_launches']:.0f} device "
                  f"launches a step; top 6 of {len(by_name)} kernels by device ms: "
                  + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top))
            del model, tr, state
            torch.cuda.empty_cache()
    return dict(card_vs_cpu=dict(metrics, rel=rel), steps=steps)


def _tr_sources(np, root):
    """The first BATCH training pairs of the corpus, (BATCH, 2, T)."""
    from sudo_rm_rf_tpu_torch.data.base import read_wav

    tr = os.path.join(root, f"wav{FS // 1000}k", "min", "tr")
    return np.stack([np.stack([read_wav(os.path.join(tr, d, f"utt{i:04d}.wav"))[1]
                               for d in ("s1", "s2")]) for i in range(BATCH)])


def _train_argv(model_type, hp, root, tmp, name, device):
    return ["--train", "WHAM", "--val", "WHAM", "--separation_task", "sep_clean",
            "--model_type", model_type, "-bs", str(BATCH), "--block_impl", "fma",
            "--audio_timelength", str(CHUNK_SECONDS), "-fs", str(FS), "--n_jobs", "4",
            "--save_checkpoint_every", "1", "--experiment_name", name,
            "-elp", os.path.join(tmp, "logs"), "-clp", os.path.join(tmp, "ckpt"),
            "--wham_root", root, "--device", device, *hp_argv(hp)]


def train_phase(torch, np, tmp: str, root: str, hp: dict, device: str = "cuda",
                reps: int = STEP_REPS) -> dict:
    """Phase 6: train, resume, serve the trained weights, hold one card step
    to the CPU and time the step. Returns the numbers for the JSON line."""
    from sudo_rm_rf_tpu_torch.cli.separate import main as separate_main
    from sudo_rm_rf_tpu_torch.cli.train import main as train_main
    from sudo_rm_rf_tpu_torch.data.base import read_wav
    from sudo_rm_rf_tpu_torch.ops import uconv as U

    logs, ckpts = os.path.join(tmp, "logs"), os.path.join(tmp, "ckpt")
    argv = _train_argv("relu", hp, root, tmp, "smoke", device)

    # the training path, with the kernel counts at 0 just before it
    U.fused_uconv_block.launches = 0
    t0 = time.perf_counter()
    out = run_cli(train_main, argv + ["--n_epochs", str(TRAIN_EPOCHS)])
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out += run_cli(train_main, argv + ["--n_epochs", str(TRAIN_EPOCHS + 1), "--resume"])
    resume_s = time.perf_counter() - t0
    train_launches = U.fused_uconv_block.launches
    print(f"train: {TRAIN_EPOCHS} epochs in {first_s:.1f} s, the resumed epoch in "
          f"{resume_s:.1f} s (model build, loader and validation included); "
          f"K1 launches {train_launches}")
    if train_launches:
        raise RuntimeError(f"the training path launched K1 {train_launches} times")
    epochs = re.findall(r"^epoch (\d+)/\d+ tr_loss=(\S+) val_SISDRi=(\S+)", out, re.M)
    if [int(e) for e, _, _ in epochs] != list(range(1, TRAIN_EPOCHS + 2)):
        raise RuntimeError(f"epoch lines {epochs}")
    resumed = re.search(r"resumed from epoch (\d+): step (\d+), Adam step (\d+)", out)
    steps_per_epoch = TRAIN_FILES // BATCH
    want = (TRAIN_EPOCHS, TRAIN_EPOCHS * steps_per_epoch, TRAIN_EPOCHS * steps_per_epoch)
    if resumed is None or tuple(map(int, resumed.groups())) != want:
        raise RuntimeError(f"resume: {resumed and resumed.group(0)}, want {want}")
    step_losses = []
    for e in range(1, TRAIN_EPOCHS + 2):
        step_losses += np.load(os.path.join(logs, "smoke", "tr_loss", f"epoch_{e}.npy")).tolist()
    val = [float(v) for _, _, v in epochs]
    if len(step_losses) != (TRAIN_EPOCHS + 1) * steps_per_epoch or not (
            np.isfinite(step_losses).all() and np.isfinite(val).all()):
        raise RuntimeError(f"step losses {step_losses}, val SISDRi {val}")
    names = os.listdir(os.path.join(ckpts, "smoke"))
    for e in range(1, TRAIN_EPOCHS + 2):
        if f"relu_epoch_{e}" not in names:
            raise RuntimeError(f"no checkpoint relu_epoch_{e} in {sorted(names)}")
    if not any(n.startswith("best_val_SISDRi") for n in names):
        raise RuntimeError(f"no best_ checkpoint in {sorted(names)}")
    last = os.path.join(ckpts, "smoke", f"relu_epoch_{TRAIN_EPOCHS + 1}")
    counts = checkpoint_counts(last)
    if counts != ((TRAIN_EPOCHS + 1) * steps_per_epoch,) * 3:
        raise RuntimeError(f"last checkpoint: step, Adam and schedule counts {counts}")
    weights = checkpoint_weights("relu", hp, last)
    print(f"train: step losses {', '.join(f'{v:.3f}' for v in step_losses)}; val SISDRi "
          f"by epoch {', '.join(f'{v:.3f}' for v in val)} dB")

    # the trained weights through the serving path
    pt = os.path.join(tmp, "trained.pt")
    torch.save(weights, pt)
    cv = os.path.join(root, f"wav{FS // 1000}k", "min", "cv")
    mix_path = os.path.join(cv, "mix_clean", "utt0000.wav")
    sep_argv = ["--checkpoint", pt, "--input", mix_path, "--out_dir", os.path.join(tmp, "sep"),
                "--device", device, "--batch_chunks", str(BATCH), "-fs", str(FS),
                "--chunk_seconds", str(CHUNK_SECONDS), *hp_argv(hp)]
    U.fused_uconv_block.launches = 0
    run_cli(separate_main, sep_argv)
    serve_launches = U.fused_uconv_block.launches
    if device == "cuda" and serve_launches != hp["num_blocks"]:
        raise RuntimeError(f"serving the trained weights: {serve_launches} K1 launches, "
                           f"want {hp['num_blocks']}")
    ests = [read_wav(os.path.join(tmp, "sep", f"utt0000_s{s}.wav"))[1] for s in (1, 2)]
    refs = [read_wav(os.path.join(cv, d, "utt0000.wav"))[1] for d in ("s1", "s2")]
    mix = read_wav(mix_path)[1]
    if not all(e.shape == mix.shape and np.isfinite(e).all() for e in ests):
        raise RuntimeError("bad separated outputs")
    best = max(sum(si_sdr_db(np, ests[i], refs[j]) for i, j in zip(p, (0, 1)))
               for p in ((0, 1), (1, 0))) / 2
    base = sum(si_sdr_db(np, mix, r) for r in refs) / 2
    print(f"serve the trained weights: {serve_launches} K1 launches; SI-SDRi of one val "
          f"file {best - base:.3f} dB")

    checks = step_checks(torch, np, "relu", hp, weights, _tr_sources(np, root), device,
                         [(i, d) for i in ("fma", "xla") for d in (None, "bfloat16")], reps)
    return dict(step_losses=step_losses, val_sisdri=val, train_launches=train_launches,
                serve_launches=serve_launches, served_sisdri_db=best - base, **checks)


def gc_train_phase(torch, np, tmp: str, root: str, hp: dict, device: str = "cuda",
                   reps: int = STEP_REPS) -> dict:
    """Phase 7: one GroupComm epoch through the fma blocks with the uniform
    mixture-consistency projection, one step card vs CPU, step times."""
    from sudo_rm_rf_tpu_torch.cli.train import main as train_main
    from sudo_rm_rf_tpu_torch.ops import uconv as U

    argv = _train_argv("groupcomm_v2", hp, root, tmp, "smoke_gc", device) + [
        "--mixture_consistency", "uniform", "--n_epochs", "1"]
    U.fused_uconv_block.launches = 0
    t0 = time.perf_counter()
    out = run_cli(train_main, argv)
    epoch_s = time.perf_counter() - t0
    launches = U.fused_uconv_block.launches
    epochs = re.findall(r"^epoch (\d+)/\d+ tr_loss=(\S+) val_SISDRi=(\S+)", out, re.M)
    losses = np.load(os.path.join(tmp, "logs", "smoke_gc", "tr_loss", "epoch_1.npy")).tolist()
    val = [float(v) for _, _, v in epochs]
    print(f"GC train: 1 epoch in {epoch_s:.1f} s (model build, loader and validation "
          f"included); K1 launches {launches}; step losses "
          f"{', '.join(f'{v:.3f}' for v in losses)}; val SISDRi {val} dB")
    if launches:
        raise RuntimeError(f"the GroupComm training path launched K1 {launches} times")
    if len(epochs) != 1 or len(losses) != TRAIN_FILES // BATCH or not (
            np.isfinite(losses).all() and np.isfinite(val).all()):
        raise RuntimeError(f"GC epoch lines {epochs}, step losses {losses}")
    weights = checkpoint_weights("groupcomm_v2", hp, os.path.join(
        tmp, "ckpt", "smoke_gc", "groupcomm_v2_epoch_1"))
    checks = step_checks(torch, np, "groupcomm_v2", hp, weights, _tr_sources(np, root),
                         device, [("fma", None), ("xla", None)], reps,
                         mixture_consistency="uniform")
    return dict(step_losses=losses, val_sisdri=val, train_launches=launches, **checks)


def _standardized_forward(torch, forward, model, impl):
    """sudo-torch-evaluate's forward: standardize each mixture (ddof=1, eps
    1e-9), separate through the blocks ``impl`` names, de-standardize."""

    def run(mix):
        mean, std = mix.mean(dim=-1, keepdim=True), mix.std(dim=-1, keepdim=True)
        return forward(model, (mix - mean) / (std + 1e-9), impl=impl) * std + mean

    return run


def eval_phase(torch, np, tmp: str, hp: dict, device: str = "cuda",
               reps: int = STEP_REPS) -> dict:
    """Phase 8: ``sudo-torch-evaluate`` of a seeded random checkpoint of
    ``hp`` on a synthetic 16 kHz WHAMR-layout test split, in crops of 4 s at
    batch 4 and then in full length (K1 launches counted each time), one
    batch's SI-SDRi against the ``xla`` blocks, fidelity, the forward's time
    per block form and profile, and BSS-eval's time per batch."""
    import pickle

    from sudo_rm_rf_tpu_torch import losses, models
    from sudo_rm_rf_tpu_torch.cli.evaluate import main as evaluate_main
    from sudo_rm_rf_tpu_torch.data.synthetic import write_whamr_corpus
    from sudo_rm_rf_tpu_torch.data.whamr import WhamRDataset
    from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast
    from sudo_rm_rf_tpu_torch.ops import uconv as U

    tag = f"U{hp['num_blocks']}/B{hp['enc_num_basis']} 16 kHz"
    chunk = int(CHUNK_SECONDS * FS16)
    t0 = time.perf_counter()
    root = write_whamr_corpus(os.path.join(tmp, "whamr16"), 0, 0, len(EVAL_SECONDS),
                              seconds=EVAL_SECONDS, fs=FS16, seed=0)
    print(f"eval: {len(EVAL_SECONDS)} WHAMR-layout test wavs of {EVAL_SECONDS} s at "
          f"{FS16} Hz written in {time.perf_counter() - t0:.1f} s")
    model = models.get_model("relu", **hp, device=device,
                             generator=torch.Generator().manual_seed(0))
    model.eval()
    ckpt = os.path.join(tmp, "u36.pt")
    torch.save(model.state_dict(), ckpt)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"eval: {tag} checkpoint of {n_params:,} params")
    argv = ["--checkpoint", ckpt, "--dataset", "WHAMR", "--separation_task",
            "noisy_reverberant", "-fs", str(FS16), "--timelength", str(CHUNK_SECONDS),
            "--batch_size", str(BATCH), "--root_dirpath", root, "--device", device,
            "--num_sources", str(hp["num_sources"]), *hp_argv(hp)]
    keys = {f"{k}_{s}" for k in ("si_sdr", "si_sdri", "sdr", "sdri", "sir", "sar")
            for s in ("mean", "median")}
    runs = {}
    for mode, extra, batches in (
            ("crops", ["--out_pickle", os.path.join(tmp, "eval.pkl")],
             len(EVAL_SECONDS) // BATCH),
            ("full_length", ["--full_length", "--n_samples", str(EVAL_FULL_LENGTH_FILES)],
             EVAL_FULL_LENGTH_FILES * n_forward_batches(int(max(EVAL_SECONDS) * FS16),
                                                        chunk, BATCH))):
        # the evaluation path, with the kernel count at 0 just before it
        U.fused_uconv_block.launches = 0
        t0 = time.perf_counter()
        out = run_cli(evaluate_main, argv + extra)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = U.fused_uconv_block.launches
        want = hp["num_blocks"] * batches if device == "cuda" else 0
        summary = json.loads(out.strip().splitlines()[-1])
        print(f"eval {mode}: {batches} forward batches, {launches} K1 launches, "
              f"{wall:.2f} s wall (checkpoint load, loader, forwards, metrics)")
        if launches != want:
            raise RuntimeError(f"eval {mode}: expected {want} K1 launches, counted {launches}")
        if not keys <= set(summary) or not all(np.isfinite(summary[k]) for k in keys):
            raise RuntimeError(f"eval {mode}: summary {summary}")
        runs[mode] = dict(summary=summary, launches=launches, forward_batches=batches,
                          wall_s=wall)

    # the first batch again, through the plain blocks: the same SI-SDRi
    ds = WhamRDataset(root_dirpath=root, task="noisy_reverberant", split="tt",
                      min_or_max="min", zero_pad=True, sample_rate=FS16,
                      timelength=CHUNK_SECONDS)
    items = [ds[i] for i in range(BATCH)]
    mix = torch.from_numpy(np.stack([s.sum(0, keepdims=True) for s, _ in items])).to(device)
    tgt = torch.from_numpy(np.stack([t[: hp["num_sources"]] for _, t in items])).to(device)
    sisdri = losses.PermInvariantSISDR(n_sources=hp["num_sources"], zero_mean=True,
                                       backward_loss=False, improvement=True,
                                       return_individual_results=True)
    est = {impl: _standardized_forward(torch, improved_forward_fast, model, impl)(mix)
           for impl in ("kernel", "xla")}
    vals = {impl: sisdri(e, tgt, initial_mixtures=mix).cpu().numpy() for impl, e in est.items()}
    cli_vals = np.asarray(pickle.load(open(os.path.join(tmp, "eval.pkl"), "rb"))["si_sdri"][:BATCH])
    diff = float(np.abs(vals["kernel"] - vals["xla"]).max())
    print(f"eval batch 1 SI-SDRi per example: CLI {np.round(cli_vals, 4).tolist()}, kernel "
          f"{np.round(vals['kernel'], 4).tolist()}, xla {np.round(vals['xla'], 4).tolist()} dB; "
          f"kernel vs xla max diff {diff:.2e} dB")
    if not diff <= MAX_SISDRI_DIFF_DB or not np.abs(cli_vals - vals["kernel"]).max() <= 1e-3:
        raise RuntimeError(f"SI-SDRi: CLI {cli_vals}, kernel {vals['kernel']}, xla {vals['xla']}")

    # fidelity and speed of one bs4 4 s forward
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((BATCH, 1, chunk))
                         .astype(np.float32)).to(device)
    U.fused_uconv_block.launches = 0
    ker = improved_forward_fast(model, x, impl="kernel")
    per_forward = U.fused_uconv_block.launches
    if per_forward != (hp["num_blocks"] if device == "cuda" else 0):
        raise RuntimeError(f"one kernel forward launched K1 {per_forward} times")
    ref = improved_forward_fast(model, x, impl="xla")
    if ker.shape != (BATCH, hp["num_sources"], chunk) or not torch.isfinite(ker).all():
        raise RuntimeError(f"bad forward output {tuple(ker.shape)}")
    fid = fidelity_db(np, ref.double().cpu().numpy(), ker.double().cpu().numpy())
    print(f"{tag} bs{BATCH} fp32 forward: {per_forward} K1 launches (counted), fidelity "
          f"kernel vs xla {fid:.2f} dB")
    if not fid >= MIN_FIDELITY_DB:
        raise RuntimeError(f"fidelity {fid:.2f} dB < {MIN_FIDELITY_DB} dB")
    out = dict(n_params=n_params, launches_per_forward=per_forward, fidelity_db=fid,
               sisdri_kernel_vs_xla_db=diff, **runs)
    if device != "cuda":
        return out
    audio_s = BATCH * CHUNK_SECONDS
    fwd = {}
    for impl in ("kernel", "fma", "xla"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(torch, lambda i=impl: improved_forward_fast(model, x, impl=i), reps=reps)
        peak = torch.cuda.max_memory_allocated() / 2**20
        fwd[impl] = dict(ms=ms, audio_s_per_s=audio_s / (ms / 1e3), peak_mib=peak)
        print(f"{tag} bs{BATCH} fp32 forward impl={impl}: {ms:.3f} ms (median of {reps}), "
              f"{audio_s / (ms / 1e3):.1f} audio-s/s, peak {peak:.0f} MiB")
    counts = {}
    named = device_ms_by_kernel(torch, lambda: improved_forward_fast(model, x, impl="kernel"),
                                3, by_part=False, launches=counts)
    busy = sum(named.values())
    k1_ms = sum(v for k, v in named.items()
                if re.search(r"\b(%s)_kernel\b" % "|".join(K1_PARTS), k))
    top = sorted(named.items(), key=lambda kv: -kv[1])[:8]
    print(f"{tag} bs{BATCH} kernel forward (torch.profiler, 3 forwards): device busy "
          f"{busy:.3f} of {fwd['kernel']['ms']:.3f} ms, idle {1 - busy / fwd['kernel']['ms']:.1%}, "
          f"K1 {k1_ms:.3f} ms, {sum(counts.values()):.0f} device launches a forward; top 8 "
          f"kernels by device ms (launches): " + "; ".join(
              f"{k[:60]} {v:.3f} ({counts[k]:.0f})" for k, v in top))
    # the metrics of one evaluation batch (crops of 4 s at 16 kHz, bs4)
    e = est["kernel"]
    bss_ms = time_ms(torch, lambda: losses.bss_eval_improvement(e, tgt, mix, filter_taps=512),
                     warmup=1, reps=reps)
    bss1_ms = time_ms(torch, lambda: losses.bss_eval_improvement(e, tgt, mix, filter_taps=1),
                      warmup=1, reps=reps)
    si_ms = time_ms(torch, lambda: sisdri(e, tgt, initial_mixtures=mix), warmup=1, reps=reps)
    print(f"eval metrics of one bs{BATCH} batch (CUDA events, median of {reps}): BSS-eval "
          f"with improvement at 512 taps {bss_ms:.3f} ms, at 1 tap {bss1_ms:.3f} ms; SI-SDRi "
          f"{si_ms:.3f} ms")
    out.update(forward=fwd, busy_ms=busy, idle_share=1 - busy / fwd["kernel"]["ms"],
               k1_device_ms=k1_ms, device_launches=sum(counts.values()),
               top_kernels_ms={k[:80]: v for k, v in top},
               bss_eval_512_ms=bss_ms, bss_eval_1_ms=bss1_ms, sisdri_ms=si_ms)
    return out


def _recipe_batch(np, dataset: str, root: str, fs: int, bs: int):
    """The first ``bs`` training items of the corpus: WHAMR (sources,
    targets), each (bs, 3, T); FUSS (bs, 4, T)."""
    from sudo_rm_rf_tpu_torch.data.setup import create_loader_for_simple_dataset

    ds = create_loader_for_simple_dataset(
        dataset, separation_task="noisy_reverberant", data_split="val", sample_rate=fs,
        timelength=CHUNK_SECONDS, root_dirpath=root)
    items = [ds[i] for i in range(bs)]
    if isinstance(items[0], tuple):
        return tuple(np.stack(x) for x in zip(*items))
    return np.stack(items)


def recipe_train_phase(torch, np, tmp: str, dataset: str, run: dict, device: str = "cuda",
                       reps: int = RECIPE_STEP_REPS, n_train: int = 16, n_val: int = 8) -> dict:
    """Phase 9: one epoch of the WHAMR or FUSS recipe through
    ``sudo-torch-train`` at the JAX package's run configuration (``run``),
    on a synthetic corpus, through the fma blocks (0 K1 launches); one step
    card vs CPU and the fp32 fma step time."""
    from sudo_rm_rf_tpu_torch.cli.train import main as train_main
    from sudo_rm_rf_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig
    from sudo_rm_rf_tpu_torch.data.synthetic import write_fuss_corpus, write_whamr_corpus
    from sudo_rm_rf_tpu_torch.ops import uconv as U
    from sudo_rm_rf_tpu_torch.train.experiment import make_recipe

    hp, fs, name = run["hp"], run["fs"], f"smoke_{dataset.lower()}"
    t0 = time.perf_counter()
    root = os.path.join(tmp, dataset.lower())
    if dataset == "FUSS":
        write_fuss_corpus(root, n_train, n_val, 0, seconds=CHUNK_SECONDS, seed=0)
    else:
        write_whamr_corpus(root, n_train, n_val, 0, seconds=CHUNK_SECONDS, fs=fs, seed=0)
    print(f"{dataset}: corpus of {n_train} + {n_val} examples of {CHUNK_SECONDS} s at {fs} Hz "
          f"in {time.perf_counter() - t0:.1f} s")
    argv = ["--train", dataset, "--val", dataset, "--model_type", "relu",
            "-bs", str(RECIPE_BATCH), "--block_impl", "fma", "--audio_timelength",
            str(CHUNK_SECONDS), "-fs", str(fs), "--n_jobs", "4", "--n_epochs", "1",
            "--loss_clamp", str(run["loss_clamp"]), "--save_checkpoint_every", "1",
            "--experiment_name", name, "-elp", os.path.join(tmp, "logs"),
            "-clp", os.path.join(tmp, "ckpt"), f"--{dataset.lower()}_root", root,
            "--device", device, *hp_argv(hp), *run["argv"]]
    # the training path, with the kernel count at 0 just before it
    U.fused_uconv_block.launches = 0
    t0 = time.perf_counter()
    out = run_cli(train_main, argv)
    epoch_s = time.perf_counter() - t0
    launches = U.fused_uconv_block.launches
    line = re.search(r"^epoch 1/1 (.*?) \(", out, re.M)
    metrics = dict(kv.split("=") for kv in line.group(1).split()) if line else {}
    losses = np.load(os.path.join(tmp, "logs", name, "tr_loss", "epoch_1.npy")).tolist()
    val = {k: float(v) for k, v in metrics.items() if k.startswith("val")}
    print(f"{dataset} train: 1 epoch in {epoch_s:.1f} s (model build, loader and validation "
          f"included); K1 launches {launches}; step losses "
          f"{', '.join(f'{v:.3f}' for v in losses)}; val {val}")
    if launches:
        raise RuntimeError(f"the {dataset} training path launched K1 {launches} times")
    want_val = (["val_SISDRi"] if dataset == "WHAMR" else
                ["val_1_srcs_SISDR"] + [f"val_{n}_srcs_SISDRi" for n in range(2, 5)])
    if (sorted(val) != want_val or len(losses) != n_train // RECIPE_BATCH
            or not (np.isfinite(losses).all() and np.isfinite(list(val.values())).all())):
        raise RuntimeError(f"{dataset} epoch line {metrics}, step losses {losses}")
    weights = checkpoint_weights("relu", hp, os.path.join(tmp, "ckpt", name, "relu_epoch_1"))
    config = ExperimentConfig(model=ModelConfig(num_sources=hp["num_sources"]),
                              data=DataConfig(train=(dataset,)))
    checks = step_checks(torch, np, "relu", hp, weights,
                         _recipe_batch(np, dataset, root, fs, RECIPE_BATCH), device,
                         [("fma", None)], reps, recipe=make_recipe(config),
                         label=f"{dataset} U16/{hp['out_channels']}", loss_clamp=run["loss_clamp"],
                         mixture_consistency=run["mixture_consistency"])
    return dict(step_losses=losses, val=val, train_launches=launches, epoch_s=epoch_s,
                **checks)


def augmented_phase(torch, np, tmp: str, hp: dict, device: str = "cuda",
                    cut: dict = AUGMENTED_CUT) -> dict:
    """Phase 14: the JAX package's train -> checkpoint -> serve loop in the
    port, at the widths of docs/runs/improved_u16_synth/hparams.json: a
    hierarchical corpus (cut to ``cut``), ``sudo-torch-train --train
    AUGMENTED_WSJMIX`` for ``TRAIN_EPOCHS`` epochs saving msgpack TrainStates, one
    more epoch resumed from them, ``sudo-torch-evaluate --dataset AUGMENTED``
    of the best checkpoint through K1 beside the ``xla`` blocks, then
    ``sudo-torch-export`` and ``sudo-torch-separate`` from the exported
    ``.pt`` and from the msgpack (identical int16 outputs)."""
    import importlib.util

    from scipy.io import wavfile

    from sudo_rm_rf_tpu_torch import losses
    from sudo_rm_rf_tpu_torch.cli.evaluate import main as evaluate_main
    from sudo_rm_rf_tpu_torch.cli.export import main as export_main
    from sudo_rm_rf_tpu_torch.cli.separate import main as separate_main
    from sudo_rm_rf_tpu_torch.cli.train import main as train_main
    from sudo_rm_rf_tpu_torch.data.setup import create_augmented_loader
    from sudo_rm_rf_tpu_torch.data.synthetic import write_hierarchical_corpus
    from sudo_rm_rf_tpu_torch.models import load_checkpoint_model
    from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast
    from sudo_rm_rf_tpu_torch.ops import uconv as U

    t_phase = time.perf_counter()
    libs = {m: importlib.util.find_spec(m) is not None for m in ("joblib", "msgpack", "flax")}
    print(f"augmented: installed here (printed only; the port uses none): {libs}")
    bs, secs = cut["batch_size"], cut["seconds"]
    t0 = time.perf_counter()
    root = write_hierarchical_corpus(
        os.path.join(tmp, "hier"), cut["train_speakers"], cut["val_speakers"],
        cut["test_speakers"], cut["utts"], cut["val_utts"], fs=FS, seconds=secs, seed=0)
    print(f"augmented: corpus cut to train {cut['train_speakers']} speakers x {cut['utts']} "
          f"utterances, val and test {cut['val_speakers']} x {cut['val_utts']} each, of "
          f"{secs} s (the JAX run: 50 x 60, 10 x 20); n_train {cut['n_train']}, n_val and "
          f"n_test {cut['n_eval']} (the JAX run: 20000, 3000); written in "
          f"{time.perf_counter() - t0:.1f} s")
    ckpts, name = os.path.join(tmp, "ckpt"), "smoke_aug"
    argv = ["--train", "AUGMENTED_WSJMIX", "--val", "AUGMENTED_WSJMIX",
            "--test", "AUGMENTED_WSJMIX",
            *[a for split in ("train", "val", "test")
              for a in (f"--{split}_dataset_paths", os.path.join(root, split))],
            "--n_train", str(cut["n_train"]), "--n_val", str(cut["n_eval"]),
            "--n_test", str(cut["n_eval"]), "-bs", str(bs), "--audio_timelength", str(secs),
            "-fs", str(FS), "-lr", "1e-3", "--clip_grad_norm", "5", "--loss_clamp", "30",
            "--n_jobs", "4", "--save_checkpoint_every", "1", "--experiment_name", name,
            "-elp", os.path.join(tmp, "logs"), "-clp", ckpts, "--device", device,
            *AUGMENTED_TRAIN_ARGV, *hp_argv(hp)]
    # the training path, with the kernel count at 0 just before it
    U.fused_uconv_block.launches = 0
    t0 = time.perf_counter()
    out = run_cli(train_main, argv + ["--n_epochs", str(TRAIN_EPOCHS)])
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out += run_cli(train_main, argv + ["--n_epochs", str(TRAIN_EPOCHS + 1), "--resume"])
    resume_s = time.perf_counter() - t0
    train_launches = U.fused_uconv_block.launches
    steps_per_epoch = cut["n_train"] // bs
    resumed = re.search(r"resumed from epoch (\d+): step (\d+), Adam step (\d+)", out)
    want = (TRAIN_EPOCHS, TRAIN_EPOCHS * steps_per_epoch, TRAIN_EPOCHS * steps_per_epoch)
    if resumed is None or tuple(map(int, resumed.groups())) != want:
        raise RuntimeError(f"resume: {resumed and resumed.group(0)}, want {want}")
    rows = re.findall(r"^epoch (\d+)/\d+ tr_loss=(\S+) val_SISDRi=(\S+) test_SISDRi=(\S+)",
                      out, re.M)
    if [int(r[0]) for r in rows] != list(range(1, TRAIN_EPOCHS + 2)) or not np.isfinite(
            np.array([r[1:] for r in rows], float)).all():
        raise RuntimeError(f"epoch lines {rows}")
    if train_launches:
        raise RuntimeError(f"the AUGMENTED training path launched K1 {train_launches} times")
    counts = checkpoint_counts(os.path.join(ckpts, name, f"relu_epoch_{TRAIN_EPOCHS + 1}"))
    if counts != ((TRAIN_EPOCHS + 1) * steps_per_epoch,) * 3:
        raise RuntimeError(f"last checkpoint: step, Adam and schedule counts {counts}")
    val = [float(r[2]) for r in rows]
    test = [float(r[3]) for r in rows]
    print(f"augmented train: {TRAIN_EPOCHS} epochs in {train_s:.1f} s, the resumed epoch in "
          f"{resume_s:.1f} s ({steps_per_epoch} steps an epoch; model build, loader and "
          f"validation included); {resumed.group(0)}; K1 launches {train_launches}; val "
          f"SISDRi by epoch {val} dB, test {test} dB")

    # the best msgpack checkpoint through sudo-torch-evaluate (K1), and the
    # same mixtures through the plain blocks
    best = next(os.path.join(ckpts, name, n) for n in sorted(os.listdir(os.path.join(ckpts, name)))
                if n.startswith("best_") and not n.endswith(".json"))
    test_root = os.path.join(root, "test")
    eval_argv = ["--checkpoint", best, "--dataset", "AUGMENTED", "--dataset_paths", test_root,
                 "--n_samples", str(cut["n_eval"]), "--timelength", str(secs),
                 "--batch_size", str(bs), "-fs", str(FS), "--device", device, *hp_argv(hp)]
    U.fused_uconv_block.launches = 0
    t0 = time.perf_counter()
    summary = json.loads(run_cli(evaluate_main, eval_argv).strip().splitlines()[-1])
    if device == "cuda":
        torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = U.fused_uconv_block.launches
    batches = cut["n_eval"] // bs
    if eval_launches != (hp["num_blocks"] * batches if device == "cuda" else 0):
        raise RuntimeError(f"evaluation: {eval_launches} K1 launches for {batches} batches")
    if summary["n_examples"] != batches * bs or not all(
            np.isfinite(v) for v in summary.values() if isinstance(v, float)):
        raise RuntimeError(f"evaluation summary {summary}")
    model = load_checkpoint_model("relu", hp, best, device)
    loader = create_augmented_loader({"test_dataset_paths": [test_root],
                                      "n_test": cut["n_eval"], "fs": FS,
                                      "audio_timelength": secs}, "test").get_generator(
        batch_size=bs, shuffle=False, num_workers=2)
    sisdri = losses.PermInvariantSISDR(n_sources=hp["num_sources"], zero_mean=True,
                                       backward_loss=False, improvement=True,
                                       return_individual_results=True)
    plain = []
    for mixture, targets in loader:
        mix = torch.from_numpy(mixture[:, None, :]).to(device)
        est = _standardized_forward(torch, improved_forward_fast, model, "xla")(mix)
        plain += sisdri(est, torch.from_numpy(targets).to(device),
                        initial_mixtures=mix).cpu().tolist()
    diff = abs(summary["si_sdri_mean"] - float(np.mean(plain)))
    print(f"augmented evaluate: {batches} batches of {bs}, {eval_launches} K1 launches "
          f"(counted), {eval_s:.2f} s wall; SI-SDRi mean {summary['si_sdri_mean']:.4f} dB "
          f"through K1, {float(np.mean(plain)):.4f} dB through the xla blocks ({diff:.2e} "
          f"apart); SDRi {summary['sdri_mean']:.4f} dB (512 taps)")
    if not diff <= MAX_SISDRI_DIFF_DB:
        raise RuntimeError(f"SI-SDRi through K1 and xla differ by {diff} dB")

    # export, then separate two test mixtures from the .pt and the msgpack
    exported = os.path.join(tmp, "exported.pt")
    t0 = time.perf_counter()
    run_cli(export_main, ["--checkpoint", best, "--out", exported, *hp_argv(hp)])
    export_s = time.perf_counter() - t0
    wavs, first = [], next(iter(loader))[0]
    for i in range(2):
        wavs.append(os.path.join(tmp, f"aug_mix{i}.wav"))
        x = first[i] / np.abs(first[i]).max() * 0.5
        wavfile.write(wavs[-1], FS, np.round(x * 32767).astype(np.int16))
    outs, sep_launches, sep_s = {}, {}, {}
    for kind, ckpt in (("pt", exported), ("msgpack", best)):
        U.fused_uconv_block.launches = 0
        t0 = time.perf_counter()
        run_cli(separate_main, ["--checkpoint", ckpt, "--input", *wavs, "--out_dir",
                                os.path.join(tmp, f"sep_{kind}"), "--device", device,
                                "--batch_chunks", str(BATCH), "-fs", str(FS),
                                "--chunk_seconds", str(CHUNK_SECONDS), *hp_argv(hp)])
        sep_s[kind] = time.perf_counter() - t0
        sep_launches[kind] = U.fused_uconv_block.launches
        outs[kind] = [wavfile.read(os.path.join(tmp, f"sep_{kind}", f"aug_mix{i}_s{s}.wav"))[1]
                      for i in range(2) for s in (1, 2)]
    identical = all(np.array_equal(a, b) for a, b in zip(outs["pt"], outs["msgpack"]))
    print(f"augmented export: {export_s:.2f} s; separate 2 files from the .pt and from the "
          f"msgpack: {sep_s['pt']:.2f} / {sep_s['msgpack']:.2f} s, K1 launches "
          f"{sep_launches['pt']} / {sep_launches['msgpack']}; int16 outputs identical: "
          f"{identical}")
    want_sep = 2 * hp["num_blocks"] if device == "cuda" else 0
    if not identical or set(sep_launches.values()) != {want_sep} or not all(
            o.shape == (int(secs * FS),) for o in outs["pt"]):
        raise RuntimeError(f"separation from .pt and msgpack: identical {identical}, "
                           f"K1 launches {sep_launches}")
    phase_s = time.perf_counter() - t_phase
    print(f"augmented phase: {phase_s:.1f} s")
    return dict(val_sisdri=val, test_sisdri=test, resumed=resumed.group(0),
                train_launches=train_launches, train_s=train_s, resume_s=resume_s,
                eval_summary=summary, eval_launches=eval_launches, eval_s=eval_s,
                sisdri_xla=float(np.mean(plain)), sisdri_kernel_vs_xla_db=diff,
                export_s=export_s, separate_s=sep_s, separate_launches=sep_launches,
                separate_identical=identical, libraries_present=libs, phase_s=phase_s)


def _musdb_epoch(out: str) -> dict:
    """The numbers of ``sudo-torch-train``'s first epoch line: its metrics
    (``val_SISDRi`` as ``val_sisdri``, ``test_SISDRi`` as ``test_sisdri``),
    phases and the bytes and copies from the host a step (0 without)."""
    m = re.search(r"^epoch 1/\d+ (.*?) \((\S+)s: data=(\S+) disp=(\S+) val=(\S+) "
                  r"ckpt=(\S+?)(?: h2d=(\d+) B/step, (\S+) copies/step)?\)$", out, re.M)
    if m is None:
        raise RuntimeError(f"no epoch line in {out[-2000:]}")
    row = {k.replace("_SISDRi", "_sisdri"): float(v)
           for k, v in (kv.split("=") for kv in m.group(1).split())}
    keys = ("epoch_s", "data_s", "disp_s", "val_s", "ckpt_s")
    row.update({k: float(v) for k, v in zip(keys, m.groups()[1:6])})
    row["h2d_bytes_per_step"] = int(m.group(7)) if m.group(7) else 0
    row["h2d_copies_per_step"] = float(m.group(8)) if m.group(8) else 0.0
    return row


def separate_musdb_track(torch, np, tmp: str, root: str, ckpt: str, hp: dict,
                         track_seconds: float, bs: int, device: str, tag: str) -> dict:
    """``sudo-torch-separate --num_sources 4`` of the first 30 s test track
    from ``ckpt`` through K1 (launches counted from 0: 16 a bs batch on a
    card), each written stem's fixed-order SI-SDRi, and the kernel forward
    of a bs batch of the track's chunks against the ``fma`` forward at the
    same weights (>= MIN_FIDELITY_DB)."""
    from sudo_rm_rf_tpu_torch.cli.separate import main as separate_main
    from sudo_rm_rf_tpu_torch.data.base import read_wav
    from sudo_rm_rf_tpu_torch.data.musdb import STEMS
    from sudo_rm_rf_tpu_torch.models import load_checkpoint_model
    from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast
    from sudo_rm_rf_tpu_torch.ops import uconv as U

    track = os.path.join(root, "test", "track000")
    n = int(track_seconds * FS)
    chunk = int(CHUNK_SECONDS * FS)
    batches = n_forward_batches(n, chunk, bs)
    sep_dir = os.path.join(tmp, f"sep_{tag}")
    U.fused_uconv_block.launches = 0
    t0 = time.perf_counter()
    run_cli(separate_main, ["--checkpoint", ckpt, "--input", os.path.join(track, "mixture.wav"),
                            "--out_dir", sep_dir, "--device", device, "--num_sources",
                            str(hp["num_sources"]), "--batch_chunks", str(bs), "-fs", str(FS),
                            "--chunk_seconds", str(CHUNK_SECONDS), *hp_argv(hp)])
    if device == "cuda":
        torch.cuda.synchronize()
    sep_s = time.perf_counter() - t0
    sep_launches = U.fused_uconv_block.launches
    want = hp["num_blocks"] * batches if device == "cuda" else 0
    if sep_launches != want:
        raise RuntimeError(f"{tag}: separating the track took {sep_launches} K1 launches, "
                           f"want {want}")
    mix = read_wav(os.path.join(track, "mixture.wav"))[1]
    ests = [read_wav(os.path.join(sep_dir, f"mixture_s{s}.wav"))[1]
            for s in range(1, hp["num_sources"] + 1)]
    if not all(e.shape == (n,) and np.isfinite(e).all() for e in ests):
        raise RuntimeError("bad separated stems")
    refs = [read_wav(os.path.join(track, f"{stem}.wav"))[1] for stem in STEMS]
    per_stem = [si_sdr_db(np, e, r) - si_sdr_db(np, mix, r) for e, r in zip(ests, refs)]
    model = load_checkpoint_model("relu", hp, ckpt, device)
    x = torch.from_numpy(np.stack([mix[i * chunk // 2:i * chunk // 2 + chunk]
                                   for i in range(bs)])[:, None]).to(device)
    ker = improved_forward_fast(model, x, impl="kernel")
    ref = improved_forward_fast(model, x, impl="fma")
    fid = fidelity_db(np, ref.double().cpu().numpy(), ker.double().cpu().numpy())
    print(f"{tag} separate: a {track_seconds} s track in {batches} batches of {bs}, "
          f"{sep_launches} K1 launches (counted), {sep_s:.2f} s wall; fixed-order SI-SDRi of "
          f"the 4 written stems {dict(zip(STEMS, (round(v, 3) for v in per_stem)))}, mean "
          f"{float(np.mean(per_stem)):.3f} dB; bs{bs} kernel forward vs fma {fid:.2f} dB")
    if not fid >= MIN_FIDELITY_DB:
        raise RuntimeError(f"fidelity {fid:.2f} dB < {MIN_FIDELITY_DB} dB")
    return dict(launches=sep_launches, forward_batches=batches, s=sep_s,
                sisdri_by_stem=dict(zip(STEMS, per_stem)), fidelity_db=fid)


def _wsj0mix_layout(np, root: str, n: int = 2, seconds: float = 0.5) -> str:
    """A tiny wsj0-2mix layout ``root/tt/{mix,s1,s2}/*.wav`` of int16 noise."""
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    for i in range(n):
        s = [rng.integers(-8000, 8000, int(seconds * FS)).astype(np.int16) for _ in range(2)]
        for d, wav in (("s1", s[0]), ("s2", s[1]), ("mix", s[0] // 2 + s[1] // 2)):
            os.makedirs(os.path.join(root, "tt", d), exist_ok=True)
            wavfile.write(os.path.join(root, "tt", d, f"01{i}a0101_0.5_20{i}c0102_-0.5.wav"),
                          FS, wav)
    return root


def musdb_init_losses(torch, np, hp: dict, batch, device: str, seeds) -> dict:
    """The fixed-assignment loss of the port's init (``--seed``) on one train
    batch, by seed, through the training forward (xla blocks, bf16), and the
    clamp it must pass for the step to have a gradient."""
    from sudo_rm_rf_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig
    from sudo_rm_rf_tpu_torch.train.experiment import make_recipe

    recipe = make_recipe(ExperimentConfig(model=ModelConfig(num_sources=hp["num_sources"]),
                                          data=DataConfig(train=("MUSDB",))))
    kw = {k: v for k, v in hp.items() if k != "group_size"}
    losses = {}
    for seed in seeds:
        model = ModelConfig(model_type="relu", block_impl="xla", **kw).build(
            device=device, generator=torch.Generator().manual_seed(seed))
        tr = Trainer(model, TrainerConfig(compute_dtype="bfloat16"), loss_fn=recipe.loss_fn,
                     prepare_batch=recipe.prepare)
        with torch.no_grad():
            mixture, targets = recipe.prepare(None, tr.upload(batch))
            losses[seed] = float(recipe.loss_fn(tr.forward(model, mixture, tr.compute_dtype),
                                                targets))
        del model, tr
    return losses


def musdb_phase(torch, np, tmp: str, hp: dict = MUSDB, device: str = "cuda",
                cut: dict = MUSDB_CUT, reps: int = STEP_REPS) -> dict:
    """The MUSDB path: a synthetic 4-stem corpus, one ``sudo-torch-train
    --train MUSDB --val MUSDB`` epoch (fixed-assignment SI-SDR, fixed-order
    val SI-SDRi; 0 K1 launches), one step card vs CPU at its checkpoint and
    the bf16 xla step's time; the same epoch with ``--upload_dtype
    bfloat16`` (losses within 0.05, half the bytes copied a step); the test
    split packed into shards (bit-identical items, the same step losses
    through a loader with a ``device_put_fn``); ``sudo-torch-separate
    --num_sources 4`` of a 30 s test track from the checkpoint through K1 (16
    launches a batch, >= 80 dB from the fma forward); a preprocessed folder
    of the port's ``prep`` read without joblib."""
    import importlib.util

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.cli.train import main as train_main
    from sudo_rm_rf_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig
    from sudo_rm_rf_tpu_torch.data.musdb import MusdbDataset
    from sudo_rm_rf_tpu_torch.data.preprocessed import PreprocessedDataset
    from sudo_rm_rf_tpu_torch.data.shards import ShardedDataset, pack_dataset
    from sudo_rm_rf_tpu_torch.data.synthetic import write_musdb_corpus
    from sudo_rm_rf_tpu_torch.ops import uconv as U
    from sudo_rm_rf_tpu_torch.prep.hierarchical import convert_wsj0mix_to_universal
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig
    from sudo_rm_rf_tpu_torch.train.experiment import make_recipe

    t_phase = time.perf_counter()
    bs, secs = cut["batch_size"], cut["seconds"]
    t0 = time.perf_counter()
    root = write_musdb_corpus(os.path.join(tmp, "musdb"), cut["train_tracks"],
                              cut["test_tracks"], fs=FS, seconds=cut["track_seconds"], seed=0)
    print(f"musdb: corpus of {cut['train_tracks']} train and {cut['test_tracks']} test tracks "
          f"of {cut['track_seconds']} s (the JAX run: 60 and 12) in "
          f"{time.perf_counter() - t0:.1f} s; n_train {cut['n_train']}, n_val {cut['n_val']} "
          f"(the JAX run: 2000, 24)")
    # the init's loss on the first train batch, for the seeds up to the one
    # trained: where it is at the clamp, the clamped loss has no gradient
    train_set = MusdbDataset(root_dirpath=root, split="train", sample_rate=FS, n_channels=1,
                             timelength=secs, augment=True, n_samples=cut["n_train"])
    first = next(iter(train_set.get_generator(batch_size=bs, shuffle=True, num_workers=2)))
    init_losses = musdb_init_losses(torch, np, hp, first, device,
                                    range(max(MUSDB_SEED + 1, MUSDB_PROBE_SEEDS)))
    print(f"musdb init loss on the first train batch by --seed (clamp {MUSDB_LOSS_CLAMP}): "
          + ", ".join(f"{k}: {v:.3f}" for k, v in init_losses.items())
          + f"; training at --seed {MUSDB_SEED}")
    if MUSDB_LOSS_CLAMP > 0 and init_losses[MUSDB_SEED] >= MUSDB_LOSS_CLAMP:
        raise RuntimeError(f"--seed {MUSDB_SEED}: the init's loss is at the clamp, so the "
                           "run would take no gradient")
    logs, ckpts = os.path.join(tmp, "logs"), os.path.join(tmp, "ckpt")
    argv = ["--train", "MUSDB", "--val", "MUSDB", "--musdb_root", root, "--seed",
            str(MUSDB_SEED),
            "--n_train", str(cut["n_train"]), "--n_val", str(cut["n_val"]), "-bs", str(bs),
            "--audio_timelength", str(secs), "-fs", str(FS), "--n_epochs", "1",
            "--n_jobs", "4", "--save_checkpoint_every", "1", "-elp", logs, "-clp", ckpts,
            "--device", device, "--loss_clamp", str(MUSDB_LOSS_CLAMP), *MUSDB_TRAIN_ARGV,
            *hp_argv(hp)]
    runs = {}
    for tag, upload in (("float32", "float32"), ("float32_again", "float32"),
                        ("bfloat16", "bfloat16")):
        name = f"musdb_{tag}"
        # the training path, with the kernel counts at 0 just before it
        U.fused_uconv_block.launches = U.fused_uconv_block.launches_bf16_pyramid = 0
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = run_cli(train_main, argv + ["--experiment_name", name, "--upload_dtype", upload])
        row = dict(_musdb_epoch(out), cli_s=time.perf_counter() - t0,
                   k1_launches=U.fused_uconv_block.launches
                   + U.fused_uconv_block.launches_bf16_pyramid)
        if device == "cuda":
            row["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        row["step_losses"] = np.load(os.path.join(logs, name, "tr_loss", "epoch_1.npy")).tolist()
        runs[tag] = row
        print(f"musdb train ({tag}: --upload_dtype {upload}): {len(row['step_losses'])} steps, "
              f"losses {', '.join(f'{v:.4f}' for v in row['step_losses'])}; val_SISDRi "
              f"{row['val_sisdri']:.3f} dB; epoch {row['epoch_s']:.1f} s (data "
              f"{row['data_s']:.1f}, disp {row['disp_s']:.1f}, val {row['val_s']:.1f}, ckpt "
              f"{row['ckpt_s']:.1f}), CLI {row['cli_s']:.1f} s; host-to-device "
              f"{row['h2d_bytes_per_step']} B a step; peak {row.get('peak_mib', 0):.0f} MiB; "
              f"K1 launches {row['k1_launches']}")
        if row["k1_launches"]:
            raise RuntimeError(f"the MUSDB training path launched K1 {row['k1_launches']} times")
        if len(row["step_losses"]) != cut["n_train"] // bs or not np.isfinite(
                row["step_losses"] + [row["val_sisdri"]]).all():
            raise RuntimeError(f"MUSDB run: {row}")
    f32, b16 = runs["float32"], runs["bfloat16"]
    gaps = {tag: np.abs(np.subtract(runs[tag]["step_losses"], f32["step_losses"])).tolist()
            for tag in ("float32_again", "bfloat16")}
    gap = max(gaps["bfloat16"])
    print(f"musdb step-loss gaps to the float32 run, by step: the float32 rerun "
          f"{', '.join(f'{v:.2e}' for v in gaps['float32_again'])}; bfloat16 uploads "
          f"{', '.join(f'{v:.2e}' for v in gaps['bfloat16'])}; epoch mean loss "
          f"{b16['tr_loss']:.3f} against {f32['tr_loss']:.3f}, val SISDRi "
          f"{b16['val_sisdri']:.3f} against {f32['val_sisdri']:.3f} dB (rtol = atol = "
          f"{UPLOAD_RTOL} on the first two steps and on these); {b16['h2d_bytes_per_step']} "
          f"against {f32['h2d_bytes_per_step']} B copied a step")
    np.testing.assert_allclose(
        b16["step_losses"][:2] + [b16["tr_loss"], b16["val_sisdri"]],
        f32["step_losses"][:2] + [f32["tr_loss"], f32["val_sisdri"]],
        rtol=UPLOAD_RTOL, atol=UPLOAD_ATOL)
    if device == "cuda" and not (
            f32["h2d_bytes_per_step"] > 0
            and 2 * b16["h2d_bytes_per_step"] == f32["h2d_bytes_per_step"]):
        raise RuntimeError("the bf16 upload did not copy half the bytes of the fp32 one")

    # one step card vs CPU at the epoch's checkpoint, and the step's time
    ckpt = os.path.join(ckpts, "musdb_float32", "relu_epoch_1")
    weights = checkpoint_weights("relu", hp, ckpt)
    recipe = make_recipe(ExperimentConfig(model=ModelConfig(num_sources=hp["num_sources"]),
                                          data=DataConfig(train=("MUSDB",))))
    batch = first
    checks = step_checks(torch, np, "relu", hp, weights, batch, device,
                         [("xla", "bfloat16")], reps, recipe=recipe, label="MUSDB U16/512",
                         cpu_batch=batch[:MUSDB_CPU_BATCH], loss_clamp=MUSDB_LOSS_CLAMP)

    # the test split's fixed items, packed into shards
    test_set = MusdbDataset(root_dirpath=root, split="test", sample_rate=FS, n_channels=1,
                            timelength=secs, n_samples=cut["n_val"])
    t0 = time.perf_counter()
    index = pack_dataset(test_set, os.path.join(tmp, "shards"), name="musdb_test")
    pack_s = time.perf_counter() - t0
    packed = ShardedDataset(index)
    item_ms = {}
    for kind, ds in (("direct", test_set), ("sharded", packed)):
        t0 = time.perf_counter()
        items = [ds[i] for i in range(len(ds))]
        item_ms[kind] = 1e3 * (time.perf_counter() - t0) / len(ds)
        if kind == "direct":
            direct = items
    if len(packed) != len(test_set) or not all(
            a[0].dtype == b.dtype and np.array_equal(a[0], b) for a, b in zip(items, direct)):
        raise RuntimeError("the sharded items differ from the direct ones")
    loss_runs = {}
    for kind, ds in (("direct", test_set), ("sharded", packed)):
        model = models.get_model("relu", **hp, block_impl="xla", device=device)
        model.load_state_dict(weights)
        tr = Trainer(model, TrainerConfig(compute_dtype="bfloat16"), loss_fn=recipe.loss_fn,
                     prepare_batch=recipe.prepare)
        state = tr.init_state()
        put = (lambda b: tr.upload(b[0])) if kind == "sharded" else None
        gen = ds.get_generator(batch_size=bs // 2, shuffle=False, num_workers=2,
                               device_put_fn=put)
        loss_runs[kind] = [float(tr.train_step(state, b, None)[1]["loss"]) for b in gen]
    print(f"musdb shards: {len(packed)} test items packed in {pack_s:.2f} s, bit-identical to "
          f"the direct items; {item_ms['direct']:.3f} ms an item direct (4 wav reads and "
          f"decodes), {item_ms['sharded']:.3f} ms sharded (one pread); step losses direct "
          f"{loss_runs['direct']}, sharded with a device_put_fn {loss_runs['sharded']}")
    # the same batches from the same weights, up to the card's run-to-run
    # spread (cuDNN's bf16 convolutions: ~1e-5 of a loss)
    np.testing.assert_allclose(loss_runs["sharded"], loss_runs["direct"], rtol=MAX_CARD_CPU_REL,
                               atol=0)
    packed.close()

    # the checkpoint through sudo-torch-separate: four stems of a 30 s track
    separate = separate_musdb_track(torch, np, tmp, root, ckpt, hp, cut["track_seconds"], bs,
                                    device, "musdb")

    # a preprocessed folder written by the port's prep, read without joblib
    pre_root = convert_wsj0mix_to_universal(_wsj0mix_layout(np, os.path.join(tmp, "wsj")),
                                            os.path.join(tmp, "pre"), 0.5)
    pre = PreprocessedDataset(root_dirpath=os.path.join(pre_root, "tt"),
                              return_items=["mixture_wav", "clean_wav_0", "clean_wav_1", "wav"])
    shapes = [tuple(a.shape) for a in pre[0]]
    joblib_here = importlib.util.find_spec("joblib") is not None
    print(f"musdb preprocessed: {len(pre)} folders, item shapes {shapes}; joblib installed "
          f"here: {joblib_here}, imported: {'joblib' in sys.modules}")
    if len(pre) != 2 or shapes != [(int(0.5 * FS),)] * 4 or "joblib" in sys.modules:
        raise RuntimeError("the preprocessed folder did not read back")
    phase_s = time.perf_counter() - t_phase
    print(f"musdb phase: {phase_s:.1f} s")
    return dict(init_losses=init_losses, seed=MUSDB_SEED, train=f32, train_bf16_upload=b16,
                upload_loss_gap=gap, **checks,
                shards=dict(pack_s=pack_s, item_ms=item_ms, step_losses=loss_runs),
                separate=separate,
                preprocessed_shapes=shapes, joblib_installed=joblib_here, phase_s=phase_s)


def hparams_argv(hp: dict) -> list:
    """``sudo-torch-train``'s flags for a run's hparams, each as written."""
    argv = []
    for key, value in hp.items():
        flag = RESIDENT_FLAGS.get(key, f"--{key}")
        if key in RESIDENT_DERIVED or value is None or value is False or value == []:
            continue
        if value is True:
            argv.append(flag)
        elif isinstance(value, list):
            argv += [flag, *map(str, value)]
        else:
            argv += [flag, str(value)]
    return argv


def published_run(path, **cut) -> tuple:
    """(argv, hparams) of the published run at ``path`` with the keys of
    ``cut`` replaced; raises unless the CLI's config of the argv holds
    exactly those hparams."""
    from sudo_rm_rf_tpu_torch.cli.args import args_to_config, build_parser

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), *path)) as fh:
        hp = json.load(fh)
    unknown = set(cut) - set(hp)
    if unknown:
        raise RuntimeError(f"{unknown} are not keys of {path}")
    hp.update(cut)
    argv = hparams_argv(hp)
    got = json.loads(json.dumps(args_to_config(build_parser().parse_args(argv)).hparams()))
    if got != hp:
        raise RuntimeError(f"{path}: the CLI took {argv} as "
                           f"{ {k: v for k, v in got.items() if hp.get(k) != v} }")
    return argv, hp


@contextlib.contextmanager
def profiled_epochs(torch, device: str, windows: list, profiled: int = RESIDENT_PROFILED):
    """Inside, each resident epoch and each host-batch epoch that
    ``sudo-torch-train`` runs in this process appends to ``windows`` its
    wall ms (from a synchronize before it to one after its last step) and,
    on a card, the device's busy ms, idle share and launches over its last
    ``profiled`` train steps (``torch.profiler`` tracing the device from a
    synchronize before the first of them to the epoch's end; the trace is
    read after the wall time is taken). A whole 50-step epoch's trace took
    17 s to collect; the profiler's host cost lands in those steps only."""
    from torch.profiler import ProfilerActivity, profile

    from sudo_rm_rf_tpu_torch.train import experiment, resident
    from sudo_rm_rf_tpu_torch.train.trainer import Trainer
    from sudo_rm_rf_tpu_torch.utils.benchmark import device_busy

    cuda = device.startswith("cuda")
    run_epoch, host_epoch, train_step = (resident.ResidentData.run_epoch,
                                         experiment.host_epoch, Trainer.train_step)
    live: dict = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def counted_step(self, *args, **kwargs):
        if "profile_from" not in live:  # a step outside an epoch (the autotuner's)
            return train_step(self, *args, **kwargs)
        live["calls"] += 1
        if cuda and live["calls"] == live["profile_from"]:
            sync()
            live["prof"] = profile(activities=[ProfilerActivity.CUDA]).__enter__()
            live["t_prof"] = time.perf_counter()
        return train_step(self, *args, **kwargs)

    def epoch(fn, steps_of):
        def wrapper(*args, **kwargs):
            steps = steps_of(*args)
            live.update(calls=0, profile_from=max(steps - profiled, 0) + 1)
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            t_end = time.perf_counter()
            del live["profile_from"]
            window = dict(steps=steps, wall_ms=1e3 * (t_end - t0))
            prof = live.pop("prof", None)
            if prof is not None:
                prof.__exit__(None, None, None)
                busy, launches = device_busy(prof)
                slice_ms = 1e3 * (t_end - live["t_prof"])
                window.update(profiled_steps=min(profiled, steps), profiled_ms=slice_ms,
                              device_busy_ms=busy, idle_share=1 - busy / slice_ms,
                              device_launches=launches)
            windows.append(window)
            return out
        return wrapper

    resident.ResidentData.run_epoch = epoch(run_epoch, lambda data, *a: data.steps_per_epoch)
    experiment.host_epoch = epoch(host_epoch, lambda trainer, state, batches, *a: len(batches))
    Trainer.train_step = counted_step
    try:
        yield
    finally:
        resident.ResidentData.run_epoch, experiment.host_epoch = run_epoch, host_epoch
        Trainer.train_step = train_step


def _autotune_table(out: str) -> tuple:
    """(pick, rows) of the ``block_impl auto`` table the CLI printed."""
    m = re.search(r"^block_impl auto -> (\w+)$", out, re.M)
    rows = [dict(impl=r[0], batch_size=int(r[1]), ms_per_step=float(r[2]),
                 audio_sec_per_sec=float(r[3]), picked=bool(r[4]))
            for r in re.findall(r"^(xla|fma) +(\d+) +(\S+) +(\S+)( \*)?$", out, re.M)]
    if m is None or not rows:
        raise RuntimeError(f"no autotune table in {out[-2000:]}")
    return m.group(1), rows


def _train_run(torch, np, train_main, argv: list, logs: str, name: str, device: str,
               steps: int, windows: list) -> tuple:
    """One ``sudo-torch-train`` epoch of ``argv`` with K1's counts at 0
    before it: the epoch line's numbers, the step losses, K1's launches,
    the epoch's ms a step (to a synchronize) and the idle share of its last
    steps (``profiled_epochs``); and the CLI's output."""
    from sudo_rm_rf_tpu_torch.ops import uconv as U

    U.fused_uconv_block.launches = U.fused_uconv_block.launches_bf16_pyramid = 0
    n_windows = len(windows)
    t0 = time.perf_counter()
    with profiled_epochs(torch, device, windows):
        out = run_cli(train_main, argv + ["-elp", logs, "--experiment_name", name,
                                          "--device", device])
    row = dict(_musdb_epoch(out), cli_s=time.perf_counter() - t0,
               k1_launches=U.fused_uconv_block.launches
               + U.fused_uconv_block.launches_bf16_pyramid)
    row["step_losses"] = np.load(os.path.join(logs, name, "tr_loss", "epoch_1.npy")).tolist()
    if len(windows) != n_windows + 1:
        raise RuntimeError(f"{name}: {len(windows) - n_windows} profiled epochs, want 1")
    window = windows[-1]
    row.update(epoch_window=window, ms_per_step=window["wall_ms"] / window["steps"],
               idle_share=window.get("idle_share"))
    if row["k1_launches"]:
        raise RuntimeError(f"{name}: the training path launched K1 {row['k1_launches']} times")
    if len(row["step_losses"]) != steps or not np.isfinite(row["step_losses"]).all():
        raise RuntimeError(f"{name}: step losses {row['step_losses']}")
    return row, out


def _fmt_idle(row: dict) -> str:
    share = row.get("idle_share")
    if share is None:
        return "not measured (no card)"
    return f"{share:.1%} over its last {row['epoch_window']['profiled_steps']} steps"


def resident_phase(torch, np, tmp: str, device: str = "cuda", cut: dict = RESIDENT_CUT,
                   aug_cut: dict = RESIDENT_AUG_CUT, rehearsal: dict | None = None) -> dict:
    """Device-resident data, chained steps, the in-flight bound, block_impl
    auto and the native reader, on the training path as the published
    recipes run it:

    (a) ``docs/runs/musdb_synth/hparams.json`` as written through
    ``sudo-torch-train`` for one 50-step epoch: the autotune table and pick,
    the pool's MiB, the bytes copied a step (0), the epoch's s, the ms a
    step and idle share of the profiled resident epoch, val SI-SDRi, 0 K1
    launches; then its checkpoint separating a 30 s track through K1.
    (b) the same epoch on host batches (no ``device_data``, ``block_impl``
    the pick), chained (25, in flight 2) and one step a dispatch (1, no
    bound), under cuDNN's deterministic algorithms: equal step losses bit
    for bit; each run's ms a step, copies a step and idle share.
    (c) ``docs/runs/improved_u16_synth_full/hparams.json`` on the AUGMENTED
    corpus cut: the val set mixed on the card from its draws against the
    host loader's items (JAX's bounds), one resident epoch's ms a step and
    idle share.
    (d) the native reader built; the header-only ``length_metadata`` over
    the corpus's wavs against the decoding one, a ``read_wav_window`` item
    against scipy's.

    ``rehearsal`` replaces hparams (widths, batch, length, clamp) for a run
    on the CPU."""
    from sudo_rm_rf_tpu_torch import native
    from sudo_rm_rf_tpu_torch.cli.train import main as train_main
    from sudo_rm_rf_tpu_torch.data import base as data_base
    from sudo_rm_rf_tpu_torch.data.musdb import STEMS
    from sudo_rm_rf_tpu_torch.data.setup import create_augmented_loader
    from sudo_rm_rf_tpu_torch.data.synthetic import (write_hierarchical_corpus,
                                                     write_musdb_corpus)
    from sudo_rm_rf_tpu_torch.train import resident

    t_phase = time.perf_counter()
    rehearsal = rehearsal or {}
    logs, windows = os.path.join(tmp, "logs"), []

    # (a) the MUSDB recipe as written
    root = write_musdb_corpus(os.path.join(tmp, "musdb"), cut["train_tracks"],
                              cut["test_tracks"], fs=FS, seconds=cut["track_seconds"], seed=0)
    argv, hp = published_run(RESIDENT_HPARAMS, n_train=cut["n_train"], n_val=cut["n_val"],
                             n_test=cut["n_val"], n_epochs=1, seed=MUSDB_SEED,
                             checkpoints_path=os.path.join(tmp, "ckpt"), **rehearsal)
    steps = hp["n_train"] // hp["batch_size"]
    print(f"resident (a): {os.path.join(*RESIDENT_HPARAMS)} as written, cut to n_train "
          f"{hp['n_train']} ({steps} steps of {hp['batch_size']}), n_val and n_test "
          f"{hp['n_val']}, 1 epoch, --seed {hp['seed']}: sudo-torch-train {' '.join(argv)}")
    a, out = _train_run(torch, np, train_main, argv + ["--musdb_root", root], logs,
                        "resident_musdb", device, steps, windows)
    pick, table = _autotune_table(out)
    pool = re.search(r"^device-resident pool: (\S+) MiB, (\d+) steps/epoch, built in (\S+)s",
                     out, re.M)
    if pool is None or int(pool.group(2)) != steps:
        raise RuntimeError(f"no resident pool of {steps} steps: {pool and pool.group(0)}")
    a.update(pick=pick, autotune=table, pool_mib=float(pool.group(1)),
             pool_build_s=float(pool.group(3)))
    timed = "; ".join(f"{r['impl']} {r['ms_per_step']} ms" for r in table)
    print(f"resident (a): block_impl auto -> {pick} ({timed}); pool {a['pool_mib']} MiB "
          f"built in {a['pool_build_s']} s; {a['h2d_bytes_per_step']} B copied from the host "
          f"a step; epoch {a['epoch_s']} s (disp {a['disp_s']}, val {a['val_s']}, ckpt "
          f"{a['ckpt_s']}), resident epoch {a['ms_per_step']:.2f} ms a step, idle "
          f"{_fmt_idle(a)}; val SI-SDRi {a['val_sisdri']:.3f} dB, test {a['test_sisdri']:.3f}; "
          f"K1 launches {a['k1_launches']}")
    if a["h2d_bytes_per_step"] != 0:
        raise RuntimeError(f"a resident step copied {a['h2d_bytes_per_step']} B from the host")
    ckpt = os.path.join(tmp, "ckpt", "resident_musdb", "relu_epoch_1")
    model_hp = {k: hp[k] for k in HP_FLAGS + ("num_sources",) if k != "group_size"}
    a["separate"] = separate_musdb_track(torch, np, tmp, root, ckpt, model_hp,
                                         cut["track_seconds"], hp["batch_size"], device,
                                         "resident")

    # (b) the same epoch on host batches, chained and one step a dispatch
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    b = {}
    try:
        for tag, chain, inflight in (("chained", 25, 2), ("single", 1, 0)):
            argv_b, _ = published_run(RESIDENT_HPARAMS, n_train=cut["n_train"],
                                      n_val=cut["n_val"], n_test=cut["n_val"], n_epochs=1,
                                      seed=MUSDB_SEED, device_data=False, block_impl=pick,
                                      chain_steps=chain, max_inflight=inflight,
                                      checkpoints_path=os.path.join(tmp, f"ckpt_{tag}"),
                                      **rehearsal)
            b[tag], _ = _train_run(torch, np, train_main, argv_b + ["--musdb_root", root],
                                   logs, f"host_{tag}", device, steps, windows)
            r = b[tag]
            print(f"resident (b) {tag} (chain_steps {chain}, max_inflight {inflight}): "
                  f"{r['ms_per_step']:.2f} ms a step, {r['h2d_copies_per_step']:g} "
                  f"copies and {r['h2d_bytes_per_step']} B from the host a step, idle "
                  f"{_fmt_idle(r)}; epoch {r['epoch_s']} s (data {r['data_s']}, disp "
                  f"{r['disp_s']}); val SI-SDRi {r['val_sisdri']:.3f} dB")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    equal = b["chained"]["step_losses"] == b["single"]["step_losses"]
    print(f"resident (b): chained and single-step losses equal bit for bit: {equal}")
    if not equal:
        raise RuntimeError(f"chained {b['chained']['step_losses']} against single "
                           f"{b['single']['step_losses']}")

    # (c) AUGMENTED: the val set mixed on the card, one resident epoch
    t0 = time.perf_counter()
    hier = write_hierarchical_corpus(
        os.path.join(tmp, "hier"), aug_cut["train_speakers"], aug_cut["val_speakers"],
        aug_cut["test_speakers"], aug_cut["utts"], aug_cut["val_utts"], fs=FS,
        seconds=aug_cut["seconds"], seed=0)
    corpus_s = time.perf_counter() - t0
    argv_c, hp_c = published_run(
        RESIDENT_AUG_HPARAMS, n_train=aug_cut["n_train"], n_val=aug_cut["n_eval"],
        n_test=aug_cut["n_eval"], n_epochs=1,
        checkpoints_path=os.path.join(tmp, "ckpt_aug"),
        **{f"{split}_dataset_paths": [os.path.join(hier, split)]
           for split in ("train", "val", "test")}, **rehearsal)
    val_set = create_augmented_loader(hp_c, "val")
    pool_c = resident.hierarchical_pool_from_dataset(val_set, device)
    mix, src = resident.mix_from_draws(pool_c.arrays, torch.from_numpy(
        val_set.random_draws.astype(np.float32)), pool_c.t_sel, pool_c.max_abs_snr)
    mix, src = mix.cpu().numpy(), src.cpu().numpy()
    gap = 0.0
    for i in range(len(val_set)):
        host_mix, host_src = val_set[i]
        np.testing.assert_allclose(mix[i], host_mix, **HOST_LOADER_TOL, err_msg=f"item {i}")
        np.testing.assert_allclose(src[i], host_src, **HOST_LOADER_TOL, err_msg=f"item {i}")
        gap = max(gap, float(np.abs(mix[i] - host_mix).max()),
                  float(np.abs(src[i] - host_src).max()))
    steps_c = hp_c["n_train"] // hp_c["batch_size"]
    c, _ = _train_run(torch, np, train_main, argv_c, logs, "resident_aug", device, steps_c,
                      windows)
    c.update(corpus_s=corpus_s, val_items=len(val_set), host_loader_max_abs=gap,
             checkpoint=os.path.join(tmp, "ckpt_aug", "resident_aug", "relu_epoch_1"),
             test_corpus=os.path.join(hier, "test"), hp={k: hp_c[k] for k in HP_FLAGS})
    print(f"resident (c): {os.path.join(*RESIDENT_AUG_HPARAMS)} on the AUGMENTED cut (corpus "
          f"{corpus_s:.1f} s): {len(val_set)} val items mixed on the card from their draws, "
          f"largest gap to the host loader {gap:.2e} (rtol 1e-4, atol 2e-5); a resident epoch "
          f"of {steps_c} steps {c['ms_per_step']:.2f} ms a step, idle {_fmt_idle(c)}, "
          f"{c['h2d_bytes_per_step']} B from the host a step; val SI-SDRi "
          f"{c['val_sisdri']:.3f} dB")

    # (d) the native reader
    wavs = sorted(os.path.join(d, f) for d, _, files in os.walk(root) for f in files
                  if f.endswith(".wav"))
    built = native.available()
    for w in wavs:  # both timings below read from the page cache
        data_base.read_wav(w)
    timing = {}
    for kind in ("header", "decode"):
        cache = os.path.join(tmp, f"meta_{kind}")
        os.makedirs(cache)
        with contextlib.ExitStack() as stack:
            if kind == "decode":
                real = native.get_lib
                native.get_lib = lambda: None
                stack.callback(setattr, native, "get_lib", real)
            t0 = time.perf_counter()
            lengths = data_base.length_metadata(cache, wavs)
            timing[kind] = time.perf_counter() - t0
        timing[f"{kind}_lengths"] = lengths
    track = os.path.join(root, "train", "track000")
    want = int(hp["audio_timelength"] * FS)
    readers = {
        "native": lambda: [data_base.read_wav_window(os.path.join(track, f"{s}.wav"), 1000, want)
                           for s in STEMS],
        "scipy": lambda: [data_base.read_wav(os.path.join(track, f"{s}.wav"))[1][1000:1000 + want]
                          for s in STEMS],
    }
    item = {kind: [] for kind in readers}
    for rep in range(RESIDENT_IO_REPS + 1):  # in turns; the first of each is a warm-up
        for kind in (("native", "scipy") if rep % 2 else ("scipy", "native")):
            t0 = time.perf_counter()
            item[f"{kind}_stems"] = np.stack(readers[kind]())
            if rep:
                item[kind].append(1e3 * (time.perf_counter() - t0))
    item.update({kind: statistics.median(item[kind]) for kind in readers})
    same = timing["header_lengths"] == timing["decode_lengths"] and np.allclose(
        item["native_stems"], item["scipy_stems"], atol=1e-6)
    d = dict(native_built=built, library=native.library_path().name, wavs=len(wavs),
             metadata_header_ms=1e3 * timing["header"], metadata_decode_ms=1e3 * timing["decode"],
             item_native_ms=item["native"], item_scipy_ms=item["scipy"], same=same)
    print(f"resident (d): native reader built: {built} ({d['library']}); length_metadata of "
          f"{len(wavs)} wavs of {cut['track_seconds']} s from the page cache: headers "
          f"{d['metadata_header_ms']:.2f} ms, decoding {d['metadata_decode_ms']:.2f} ms; a "
          f"4-stem {hp['audio_timelength']} s item (median of {RESIDENT_IO_REPS}, in turns): "
          f"read_wav_window {d['item_native_ms']:.3f} ms, scipy {d['item_scipy_ms']:.3f} ms; "
          f"the same lengths and samples: {same}")
    if not built or not same:
        raise RuntimeError(f"native reader: {d}")
    phase_s = time.perf_counter() - t_phase
    print(f"resident phase: {phase_s:.1f} s")
    return dict(musdb=a, host=b, augmented=c, native=d, phase_s=phase_s)


def _snr_db(torch, ref, est) -> float:
    """10 log10 of |ref|^2 over |ref - est|^2, in float64; inf if equal."""
    ref, est = ref.double(), est.double()
    err = float(((ref - est) ** 2).sum())
    return float("inf") if err == 0.0 else 10 * math.log10(float((ref**2).sum()) / err)


def upsum_bound_ms(b, ci, t, depth, level_bytes: int) -> float:
    """Least time (ms) of K1's upsample-sum: its levels read once at
    ``level_bytes`` a value and its fp32 output written once."""
    levels = b * ci * sum(t >> k for k in range(depth))
    from sudo_rm_rf_tpu_torch.utils.benchmark import H100_BYTES_PER_S

    return 1e3 * (level_bytes * levels + 4 * b * ci * t) / H100_BYTES_PER_S


def k1_bf16_phase(torch, U) -> dict:
    """K1 with a bf16 pyramid at the flagship B=4, the GroupComm folded and
    the U36 B=4 shapes: against its plain version (``uconv_block_levelwise``
    with the same pyramid, on the card) on the block's change (out - x), two
    calls bit-identical, its distance to the fp32 pyramid's output, and its
    time and parts beside the fp32 pyramid's."""
    from sudo_rm_rf_tpu_torch.utils.benchmark import k1_bound

    bf = torch.bfloat16
    rows = {}
    for b, co, ci, t, depth in PYRAMID_SHAPES:
        name = ("groupcomm" if (b, co, ci, t, depth) == GC_BLOCK
                else "u36" if (b, co, ci, t, depth) == U36_BLOCK else "flagship")
        label = f"K1 bf16 pyramid {name} {(b, co, ci, t, depth)}"
        p = block_params(torch, depth, ci, co, seed=0)
        x = torch.randn(b, co, t, generator=torch.Generator().manual_seed(1)).cuda()
        got = U.fused_uconv_block(x, p, depth, bf)
        torch.cuda.synchronize()
        want = U.uconv_block_levelwise(x, p, depth, bf)
        snr = _snr_db(torch, want - x, got - x)
        diff = (got - want).abs()
        err, past = diff.max().item(), int((diff > PYRAMID_MAX_ABS).sum())
        # what bf16 rounding flips alone give: the plain version in float64
        want64 = U.uconv_block_levelwise(x.double(), {k: v.double() for k, v in p.items()},
                                         depth, bf)
        spread = (want.double() - want64).abs().max().item()
        fp = U.fused_uconv_block(x, p, depth)
        snr_fp = _snr_db(torch, fp - x, got - x)
        print(f"{label}: vs its plain version {snr:.2f} dB on (out - x), max_abs_err "
              f"{err:.3e}, {past} of {diff.numel()} outputs past {PYRAMID_MAX_ABS} (the plain "
              f"version in fp32 and in float64 part by up to {spread:.3e}); vs the "
              f"fp32-pyramid K1 {snr_fp:.2f} dB")
        if not (snr >= PYRAMID_MIN_DB and past <= PYRAMID_FLIP_SHARE * diff.numel()
                and err <= PYRAMID_FLIP_MAX):
            raise RuntimeError(f"{label}: {snr:.2f} dB, {past} outputs past "
                               f"{PYRAMID_MAX_ABS}, max |delta| {err:.3e}")
        if not torch.equal(got, U.fused_uconv_block(x, p, depth, bf)):
            raise RuntimeError(f"{label}: two calls differ")
        call_bf = lambda: U.fused_uconv_block(x, p, depth, bf)
        call_fp = lambda: U.fused_uconv_block(x, p, depth)
        ms = {"bf16": time_ms(torch, call_bf), "fp32": time_ms(torch, call_fp),
              "bf16_again": time_ms(torch, call_bf), "fp32_again": time_ms(torch, call_fp)}
        plain_ms = time_ms(torch, lambda: U.uconv_block_levelwise(x, p, depth, bf),
                           warmup=1, reps=5)
        parts = {k: device_ms_by_kernel(torch, c, 20) for k, c in (("bf16", call_bf),
                                                                   ("fp32", call_fp))}
        acc_in = torch.randn(b, ci, t, generator=torch.Generator().manual_seed(2)).cuda()
        lib_ms = time_ms(torch, lambda: (torch.matmul(p["proj_w"], x),
                                         torch.matmul(p["res_w"], acc_in)))
        bound = k1_bound(b, co, ci, t, depth)
        ub = {k: upsum_bound_ms(b, ci, t, depth, n) for k, n in (("bf16", 2), ("fp32", 4))}
        print(f"{label} ms (median of 25, in turns bf16 / fp32 / bf16 / fp32): "
              f"{ms['bf16']:.4f} / {ms['fp32']:.4f} / {ms['bf16_again']:.4f} / "
              f"{ms['fp32_again']:.4f}; plain {plain_ms:.3f}; torch.matmul of its two "
              f"products {lib_ms:.4f}; bound {bound['bound_ms']:.4f} ({bound['bound_by']})")
        for k in ("bf16", "fp32"):
            print(f"{label} device ms per call by part, {k} pyramid (torch.profiler, 20 "
                  "calls): " + (", ".join(f"{n} {parts[k][n]:.4f}" for n in K1_PARTS
                                         if n in parts[k]) or "not measured")
                  + f"; upsum bound {ub[k]:.4f} ms ({'2' if k == 'bf16' else '4'}-byte "
                  "levels read once, fp32 acc written once)")
        rows[name] = dict(
            shape=f"B,Co,Ci,T,depth={b},{co},{ci},{t},{depth}", max_abs_err=err,
            outputs_past_2e_3=past, plain_fp32_vs_float64_max_abs=spread,
            snr_vs_plain_db=snr, snr_vs_fp32_pyramid_db=snr_fp, ms=ms["bf16"],
            ms_again=ms["bf16_again"], fp32_pyramid_ms=ms["fp32"],
            fp32_pyramid_ms_again=ms["fp32_again"], plain_ms=plain_ms,
            bound_ms=bound["bound_ms"], bound_by=bound["bound_by"], library_ms=lib_ms,
            library_call="torch.matmul of the proj and res products",
            parts_ms={k: parts["bf16"].get(k) for k in K1_PARTS},
            fp32_pyramid_parts_ms={k: parts["fp32"].get(k) for k in K1_PARTS},
            bit_identical=True)
    return rows


def k1_float64_phase(torch, U) -> dict:
    """K1 and the fp32 plain block, each against a float64 plain block on
    the same input, at K = Co = 256 and 512: if K1's error grew faster with
    K than the fp32 reference's, its hi/lo summation would be at fault."""
    out = {}
    for b, co, ci, t, depth in F64_SHAPES:
        p = block_params(torch, depth, ci, co, seed=0)
        x = torch.randn(b, co, t, generator=torch.Generator().manual_seed(1)).cuda()
        want = U.uconv_block_reference(x.double(), {k: v.double() for k, v in p.items()}, depth)
        errs = {}
        for form, y in (("k1", U.fused_uconv_block(x, p, depth)),
                        ("fp32_reference", U.uconv_block_reference(x, p, depth)),
                        ("fp32_levelwise", U.uconv_block_levelwise(x, p, depth))):
            d = y.double() - want
            errs[form] = dict(max_abs=d.abs().max().item(), rms=d.pow(2).mean().sqrt().item())
        print(f"K1 float64 check {(b, co, ci, t, depth)}: max |err| / rms against float64: "
              + "; ".join(f"{k} {v['max_abs']:.3e} / {v['rms']:.3e}" for k, v in errs.items()))
        out[f"K={co}"] = errs
    for form in ("k1", "fp32_reference", "fp32_levelwise"):
        lo, hi = out[f"K={F64_SHAPES[0][1]}"][form], out[f"K={F64_SHAPES[1][1]}"][form]
        print(f"K1 float64 check: {form} error growth K=256 -> 512: max x"
              f"{hi['max_abs'] / lo['max_abs']:.2f}, rms x{hi['rms'] / lo['rms']:.2f}")
    for key, before in K1_F64_BEFORE.items():
        now = out[key]["k1"]
        print(f"K1 float64 check {key}: max |err| {now['max_abs']:.3e} (before the wide GEMM "
              f"{before['max_abs']:.3e}), rms {now['rms']:.3e} (before {before['rms']:.3e})")
        if any(now[m] > K1_F64_SLACK * before[m] for m in ("max_abs", "rms")):
            raise RuntimeError(f"K1 float64 check {key}: {now} past {K1_F64_SLACK}x {before}")
    return out


def bf16_serve_phase(torch, np, model_type: str, hp: dict, device: str = "cuda") -> dict:
    """bf16 serving of ``hp``: every impl of the fast forward with
    ``compute_dtype="bfloat16"`` from a copy cast once for it (the 'kernel'
    copy rounded and held in fp32, the others' in bf16), against its own fp32
    output (>= BF16_GATE_DB), K1 counted; the kernel impl also with K1's
    bf16 pyramid; kernel against xla in bf16; bs4 and bs8 times."""
    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.models import fast_inference as fi
    from sudo_rm_rf_tpu_torch.ops import uconv as U

    gc = model_type == "groupcomm_v2"
    forward = fi.groupcomm_forward_fast if gc else fi.improved_forward_fast
    tag = "GC U16/512" if gc else "U16/512"
    chunk = int(CHUNK_SECONDS * FS)
    model = models.get_model(model_type, **hp, device=device,
                             generator=torch.Generator().manual_seed(0)).eval()
    casts = {impl: fi.cast_model(model, torch.bfloat16, impl) for impl in ("kernel", None)}
    cast = lambda impl: casts["kernel" if impl == "kernel" else None]  # noqa: E731
    rng = np.random.default_rng(3)
    xs = {bs: torch.from_numpy(rng.standard_normal((bs, 1, chunk)).astype(np.float32)).to(device)
          for bs in SERVE_BATCHES}
    x = xs[BATCH]
    # name -> the bf16 forward's arguments
    variants = {i: dict(impl=i, compute_dtype="bfloat16", pyramid_dtype=torch.float32)
                for i in (fi.GC_IMPLS if gc else ("kernel", "fma", "xla"))}
    variants["kernel_bf16_pyramid"] = dict(variants["kernel"], pyramid_dtype=torch.bfloat16)
    out, outs = {}, {}
    for name, kw in variants.items():
        impl = kw["impl"]
        fp = forward(model, x, impl=impl)
        U.fused_uconv_block.launches = U.fused_uconv_block.launches_bf16_pyramid = 0
        bf = forward(cast(impl), x, **kw)
        launches = (U.fused_uconv_block.launches, U.fused_uconv_block.launches_bf16_pyramid)
        fid = fidelity_db(np, fp.double().cpu().numpy(), bf.double().cpu().numpy())
        outs[name] = bf
        want = (hp["num_blocks"], hp["num_blocks"] if name == "kernel_bf16_pyramid" else 0) \
            if impl == "kernel" and device == "cuda" else (0, 0)
        print(f"{tag} bs{BATCH} bf16 forward {name}: {fid:.2f} dB against its fp32 forward, "
              f"K1 launches {launches[0]} (bf16 pyramid {launches[1]})")
        if bf.dtype != torch.float32 or not torch.isfinite(bf).all():
            raise RuntimeError(f"{tag} bf16 {name}: output {bf.dtype}")
        if not fid >= BF16_GATE_DB or launches != want:
            raise RuntimeError(f"{tag} bf16 {name}: {fid:.2f} dB, launches {launches}, "
                               f"want >= {BF16_GATE_DB} dB and {want}")
        out[name] = dict(fidelity_vs_fp32_db=fid, k1_launches=launches[0],
                         k1_bf16_pyramid_launches=launches[1])
    kx = fidelity_db(np, outs["xla"].double().cpu().numpy(), outs["kernel"].double().cpu().numpy())
    print(f"{tag} bs{BATCH} bf16 forward kernel against xla: {kx:.2f} dB")
    out["kernel_vs_xla_db"] = kx
    if device != "cuda":
        return out
    for name, kw in variants.items():
        for bs, xb in xs.items():
            ms = time_ms(torch, lambda: forward(cast(kw["impl"]), xb, **kw), reps=10)
            out[name][f"bs{bs}_ms"] = ms
            out[name][f"bs{bs}_audio_s_per_s"] = bs * CHUNK_SECONDS / (ms / 1e3)
        print(f"{tag} bf16 forward {name}: bs4 {out[name]['bs4_ms']:.3f} ms "
              f"({out[name]['bs4_audio_s_per_s']:.1f} audio-s/s), bs8 {out[name]['bs8_ms']:.3f} "
              f"ms ({out[name]['bs8_audio_s_per_s']:.1f} audio-s/s), median of 10")
    return out


def int8_phase(torch, np, model_type: str, hp: dict, device: str = "cuda") -> dict:
    """int8 serving of ``hp`` at bs8 (``models/quantized.py``): fidelity of
    the dynamic and the static (calibrated) forward against the fp32 serving
    forward, the 25 dB gate, the times, and that ``torch._int_mm`` ran on
    the card at every quantized site."""
    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.models import fast_inference as fi
    from sudo_rm_rf_tpu_torch.models import quantized as q

    gc = model_type == "groupcomm_v2"
    tag = "GC U16/512" if gc else "U16/512"
    chunk = int(CHUNK_SECONDS * FS)
    model = models.get_model(model_type, **hp, device=device,
                             generator=torch.Generator().manual_seed(0)).eval()
    kw = dict(upsampling_depth=hp["upsampling_depth"], enc_kernel_size=hp["enc_kernel_size"],
              num_sources=hp["num_sources"])
    if gc:
        kw.update(num_blocks=hp["num_blocks"], group_size=hp["group_size"])
        qp, fwd, calib = q.quantize_gc_params(model), q.groupcomm_forward_int8, q.calibrate_gc_scales
        ref_fwd, sites = fi.groupcomm_forward_fast, 4 * hp["num_blocks"] + 2
    else:
        qp = q.quantize_improved_params(model)
        fwd, calib = q.improved_forward_int8, q.calibrate_improved_scales
        ref_fwd, sites = fi.improved_forward_fast, 2 * hp["num_blocks"] + 2
    rng = np.random.default_rng(4)
    x8 = torch.from_numpy(rng.standard_normal((8, 1, chunk)).astype(np.float32)).to(device)
    held_out = torch.from_numpy(rng.standard_normal((BATCH, 1, chunk)).astype(np.float32))
    scales = calib(qp, held_out.to(device), **kw)
    ref = ref_fwd(model, x8)
    out = {}
    for mode, sc in (("dynamic", None), ("static", scales)):
        y = fwd(qp, x8, scales=sc, **kw)
        fid = q.fidelity_db(ref, y)
        print(f"{tag} bs8 int8 {mode} scales: {fid:.2f} dB against the fp32 serving forward "
              f"(gate {INT8_GATE_DB} dB: {'passed' if fid >= INT8_GATE_DB else 'failed'})")
        if y.dtype != torch.float32 or not torch.isfinite(y).all() or not fid >= INT8_MIN_DB:
            raise RuntimeError(f"{tag} int8 {mode}: {fid:.2f} dB, output {y.dtype}")
        out[mode] = dict(fidelity_db=fid, gate_passed=fid >= INT8_GATE_DB)
    if device != "cuda":
        return out
    for mode, sc in (("dynamic", None), ("static", scales)):
        ms = time_ms(torch, lambda: fwd(qp, x8, scales=sc, **kw), reps=10)
        out[mode].update(bs8_ms=ms, bs8_audio_s_per_s=8 * CHUNK_SECONDS / (ms / 1e3))
        print(f"{tag} bs8 int8 {mode}: {ms:.3f} ms ({8 * CHUNK_SECONDS / (ms / 1e3):.1f} "
              "audio-s/s), median of 10")
    # torch._int_mm on the card: one static forward under the profiler
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd(qp, x8, scales=scales, **kw)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.key == "aten::_int_mm"]
    calls = ev[0].count if ev else 0
    dev_ms = (getattr(ev[0], "device_time_total", None) or getattr(ev[0], "cuda_time_total", 0)) \
        / 1e3 if ev else 0.0
    print(f"{tag} bs8 int8 static forward: aten::_int_mm called {calls} times (quantized "
          f"sites {sites}), device ms under it {dev_ms:.3f} (torch.profiler)")
    if calls != sites:
        raise RuntimeError(f"{tag}: torch._int_mm ran {calls} times, want {sites}")
    out.update(int_mm_calls=calls, int_mm_device_ms=dev_ms)
    return out


def bench_phase(torch) -> dict:
    """``sudo-torch-bench`` at the zoo's U16/512, GroupComm and U36 rows (bs1
    and bs4, fp32 and bf16) and one backward row, K1 counted, then the
    headline ``python -m sudo_rm_rf_tpu_torch.bench``; its gates printed."""
    from sudo_rm_rf_tpu_torch import bench as headline
    from sudo_rm_rf_tpu_torch.cli.bench import main as bench_main
    from sudo_rm_rf_tpu_torch.ops import uconv as U

    zoo = ["--models", "sudormrf_R16", "groupcomm_R16", "sudormrf_R36_B4096",
           "--batch_sizes", "1", "4"]
    runs = {
        "fp32": zoo,
        "bf16": zoo + ["--dtype", "bfloat16"],
        "backward": ["--models", "sudormrf_R16", "--measures", "backward", "--batch_sizes", "4"],
    }
    out = {}
    for name, argv in runs.items():
        # each bench run, with the kernel counts at 0 just before it
        U.fused_uconv_block.launches = 0
        t0 = time.perf_counter()
        rows = [json.loads(line) for line in run_cli(bench_main, argv).strip().splitlines()]
        out[name] = dict(rows=rows, seconds=time.perf_counter() - t0,
                         k1_launches=U.fused_uconv_block.launches)
        print(f"sudo-torch-bench {name}: {len(rows)} rows in {out[name]['seconds']:.1f} s, K1 "
              f"launches {out[name]['k1_launches']}")
        if any(not r["secs_per_batch"] > 0 or "mfu_pct" not in r for r in rows):
            raise RuntimeError(f"sudo-torch-bench {name}: a row lacks a time or mfu_pct")
    if not (out["fp32"]["k1_launches"] and out["bf16"]["k1_launches"]):
        raise RuntimeError("the bench's serving rows did not run K1")
    U.fused_uconv_block.launches = 0
    t0 = time.perf_counter()
    line = json.loads(run_cli(lambda argv: headline.main(argv, reps=HEADLINE_REPS), [])
                      .strip().splitlines()[-1])
    print(f"headline: {line['value']} {line['unit']} ({line['config']}), bf16 gate "
          f"{'passed' if line['bf16_gate_passed'] else 'failed'} at "
          f"{line['bf16_fidelity_db']} dB, int8 gate "
          f"{'passed' if line['int8_gate_passed'] else 'failed'} at "
          f"{line['int8_fidelity_db']} dB; K1 launches {U.fused_uconv_block.launches}; "
          f"{time.perf_counter() - t0:.1f} s")
    out["headline"] = line
    return out


def zoo_weights(torch, model_type: str, hp: dict) -> dict:
    """Seeded random weights of a model of the family, drawn on the host;
    a causal model's skip-init gains set to CAUSAL_GAIN."""
    from sudo_rm_rf_tpu_torch import models

    model = models.get_model(model_type, **hp, generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    for k in sd:
        if k.endswith("skipinit_gain"):
            sd[k] = torch.tensor(CAUSAL_GAIN)
    return sd


def zoo_model(torch, model_type: str, hp: dict, weights: dict, device: str, **kw):
    from sudo_rm_rf_tpu_torch import models

    model = models.get_model(model_type, **hp, **kw, device=device)
    model.load_state_dict(weights)
    return model


def profiled_ms(torch, fn, label: str, reps: int = 5, calls: int = 3) -> dict:
    """Median ms of fn (CUDA events), the device's busy time, idle share and
    launches a call (``torch.profiler``), and the top kernels."""
    ms = time_ms(torch, fn, warmup=2, reps=reps)
    counts = {}
    by_name = device_ms_by_kernel(torch, fn, calls, by_part=False, launches=counts)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    row = dict(ms=ms, device_busy_ms=busy, idle_share=1 - busy / ms,
               device_launches=sum(counts.values()), top_kernels_ms={k[:80]: v for k, v in top})
    print(f"{label}: {ms:.3f} ms (median of {reps}); torch.profiler over {calls} calls: "
          f"device busy {busy:.3f} ms, idle {row['idle_share']:.1%}, "
          f"{row['device_launches']:.0f} device launches a call; top 6 kernels by device "
          f"ms: " + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top))
    return row


def card_vs_cpu_forward(torch, np, model_type: str, hp: dict, weights: dict, device: str,
                        label: str) -> dict:
    """One bs1 4 s forward of the same weights and input on the card and on
    the CPU (TF32 off): fidelity >= MIN_FIDELITY_DB."""
    x = np.random.default_rng(3).standard_normal((1, hp.get("in_audio_channels", 1),
                                                  int(CHUNK_SECONDS * FS))).astype(np.float32)
    outs = {}
    for dev in (device, "cpu"):
        model = zoo_model(torch, model_type, hp, weights, dev).eval()
        with torch.no_grad():
            outs[dev] = model(torch.from_numpy(x).to(dev)).double().cpu().numpy()
        del model
    fid = fidelity_db(np, outs["cpu"], outs[device])
    err = float(np.abs(outs["cpu"] - outs[device]).max())
    print(f"{label} bs1 forward card vs CPU: fidelity {fid:.2f} dB, max |delta| {err:.3e} "
          f"(max |out| {np.abs(outs['cpu']).max():.3e})")
    if not (np.isfinite(outs[device]).all() and fid >= MIN_FIDELITY_DB):
        raise RuntimeError(f"{label}: card vs CPU fidelity {fid:.2f} dB")
    return dict(fidelity_db=fid, max_abs_err=err)


def _brown_batch(np, b: int, s: int, t: int, seed: int):
    x = np.cumsum(np.random.default_rng(seed).standard_normal((b, s, t)), axis=-1)
    return (x / x.std(axis=-1, keepdims=True)).astype(np.float32)


def zoo_train_step(torch, np, model_type: str, hp: dict, weights: dict, device: str,
                   label: str, reps: int = ZOO_STEP_REPS, batch_size: int = BATCH,
                   optimizer: str = "adam", **model_kw) -> dict:
    """A fp32 train step at ``batch_size`` (WHAM remix, PIT SI-SDR with the
    clamp off, so a random model's loss never saturates it; clip 5,
    ``optimizer``): its median ms, idle share, launches and the allocator's
    peak. Attentive models train with ``train_dropout`` on."""
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig, draw_remix

    dropout = model_type.startswith("attention")
    model = zoo_model(torch, model_type, hp, weights, device, **model_kw)
    tr = Trainer(model, TrainerConfig(loss_clamp=0.0, train_dropout=dropout, dropout_seed=0,
                                      optimizer=optimizer))
    state, gen = tr.init_state(), torch.Generator().manual_seed(0)
    batch = torch.from_numpy(_brown_batch(np, batch_size, 2, int(CHUNK_SECONDS * FS), 4)
                             ).to(device)
    step = lambda: tr.train_step(state, batch, draw_remix(gen, batch_size, 2))
    _, m = step()
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"{label} train step: loss {loss}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    row = profiled_ms(torch, step, f"{label} bs{batch_size} fp32 {optimizer} train step"
                      + (" (train_dropout)" if dropout else ""), reps=reps, calls=2)
    row.update(peak_mib=torch.cuda.max_memory_allocated() / 2**20, loss=loss,
               train_dropout=dropout, optimizer=optimizer, batch_size=batch_size)
    print(f"{label} train step: peak {row['peak_mib']:.0f} MiB, first loss {loss:.4f}")
    del model, tr, state
    torch.cuda.empty_cache()
    return row


def causal_phase(torch, np, device: str = "cuda", hp: dict = CAUSAL,
                 check_context: int = STREAM_CHECK_CONTEXT, stream_seconds: float = 4.0,
                 stream_settings=(STREAM_HOP, STREAM_CONTEXT)) -> dict:
    """Causal SuDoRM-RF v3 at the JAX class defaults: the bs4 offline
    forward (ms, idle share, launches, 0 K1 launches), card against CPU on
    one forward, ``StreamingSeparator`` on the card (streamed against the
    offline forward past the head, emission stability bit for bit, the
    per-push time), the streaming bench for 1 and 16 streams, and one bs4
    train step."""
    import sudo_rm_rf_tpu_torch.bench_streaming as bench_streaming
    from sudo_rm_rf_tpu_torch.inference import StreamingSeparator
    from sudo_rm_rf_tpu_torch.models.causal_sudormrf import CausalConv1d
    from sudo_rm_rf_tpu_torch.ops import uconv as U

    weights = zoo_weights(torch, "causal", hp)
    model = zoo_model(torch, "causal", hp, weights, device).eval()
    masked = sum(isinstance(m, CausalConv1d) and m.masked for m in model.modules())
    t = int(CHUNK_SECONDS * FS)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((BATCH, 1, t))
                         .astype(np.float32)).to(device)

    def fwd():
        with torch.inference_mode():
            return model(x)

    # the offline path, with the K1 count at 0 just before it
    U.fused_uconv_block.launches = 0
    out = fwd()
    if out.shape != (BATCH, 2, t) or not torch.isfinite(out).all():
        raise RuntimeError(f"causal forward: shape {tuple(out.shape)}")
    res = dict(masked_convs_per_forward=masked)
    if device == "cuda":
        res["forward"] = profiled_ms(torch, fwd, f"causal U16/512 bs{BATCH} fp32 forward")
        print(f"causal: {masked} masked convs a forward, one weight-mask multiply each "
              f"(not precomputed)")
    res["k1_launches"] = U.fused_uconv_block.launches
    if res["k1_launches"]:
        raise RuntimeError(f"the causal path launched K1 {res['k1_launches']} times")
    res["card_vs_cpu"] = card_vs_cpu_forward(torch, np, "causal", hp, weights, device,
                                             "causal U16/512")

    # streaming on the card: streamed against offline past the head
    n = int(stream_seconds * FS)
    mixture = (0.5 * np.cumsum(np.random.default_rng(2).standard_normal(n))
               / np.sqrt(n)).astype(np.float32)
    sep = StreamingSeparator(model, hop_samples=STREAM_HOP, context_samples=check_context)
    t0 = time.perf_counter()
    streamed = sep.separate_stream(mixture)
    stream_s = time.perf_counter() - t0
    with torch.inference_mode():
        offline = model(torch.from_numpy(mixture[None, None]).to(device)).cpu().numpy()[0]
    head, tail = check_context, hp["enc_kernel_size"] // 2 + 1
    fid = fidelity_db(np, offline[:, head:-tail].astype(np.float64),
                      streamed[:, head:-tail].astype(np.float64))
    err = float(np.abs(offline[:, head:-tail] - streamed[:, head:-tail]).max())
    half = n // 2
    shorter = sep.separate_stream(mixture[:half])
    stable = bool(np.array_equal(shorter[:, :half - sep.lookahead],
                                 streamed[:, :half - sep.lookahead]))
    print(f"causal streaming (hop {STREAM_HOP}, context {check_context}, lookahead "
          f"{sep.lookahead}): {n} samples in {stream_s:.2f} s; streamed vs offline on "
          f"[{head}, {n - tail}): {fid:.2f} dB, max |delta| {err:.3e}; a half-length "
          f"stream emits bit-identical samples: {stable}")
    if not (fid >= MIN_FIDELITY_DB and stable):
        raise RuntimeError(f"streaming: {fid:.2f} dB against offline, stable {stable}")
    res["streaming_check"] = dict(context=check_context, fidelity_db=fid, max_abs_err=err,
                                  emission_stable=stable, stream_s=stream_s)

    # the push of one stream at the bench's settings, as a caller sees it
    hop, context = stream_settings
    sep = StreamingSeparator(model, hop_samples=hop, context_samples=context)
    hops = [mixture[i * hop:(i + 1) * hop] for i in range(60)]
    times = []
    for h in hops:
        t0 = time.perf_counter()
        sep.push(h)
        times.append(1e3 * (time.perf_counter() - t0))
    push_ms = statistics.median(times[10:])
    print(f"causal StreamingSeparator.push (hop {hop}, context {context}, host clock, "
          f"the copy back included): median {push_ms:.3f} ms of {1e3 * hop / FS:.0f} ms "
          f"of audio")
    res["push_ms"] = push_ms
    if device == "cuda":
        lines = run_cli(bench_streaming.main, ["--hop", str(hop), "--context", str(context),
                                               "--streams", *map(str, STREAM_COUNTS)])
        res["bench_streaming"] = [json.loads(ln) for ln in lines.splitlines()
                                  if ln.startswith("{")]
        if len(res["bench_streaming"]) != len(STREAM_COUNTS):
            raise RuntimeError(f"bench_streaming printed {lines!r}")
        res["train_step"] = zoo_train_step(torch, np, "causal", hp, weights, device,
                                           "causal U16/512")
    del model, sep
    return res


def zoo_phase(torch, np, device: str = "cuda", zoo: dict = ZOO,
              remat_hp: dict = FLAGSHIP) -> dict:
    """v1 and attentive v1-v3 at full width: the bs4 fp32 forward (ms, idle
    share, launches, peak, 0 K1 launches), card against CPU on one forward,
    one bs4 train step each (attentive with train_dropout); then
    ``remat_blocks`` on Improved U16/512: the step's ms and peak with and
    without it, and the grads of one step against each other."""
    from sudo_rm_rf_tpu_torch.ops import uconv as U
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig, draw_remix

    res = {}
    t = int(CHUNK_SECONDS * FS)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((BATCH, 1, t))
                         .astype(np.float32)).to(device)
    for model_type, hp in zoo.items():
        label = f"{model_type} U{hp['num_blocks']}/{hp['enc_num_basis']}"
        weights = zoo_weights(torch, model_type, hp)
        model = zoo_model(torch, model_type, hp, weights, device).eval()

        def fwd():
            with torch.inference_mode():
                return model(x)

        row = {}
        U.fused_uconv_block.launches = 0
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        out = fwd()
        if out.shape != (BATCH, hp["num_sources"], t) or not torch.isfinite(out).all():
            raise RuntimeError(f"{label} forward: shape {tuple(out.shape)}")
        if device == "cuda":
            row["forward"] = profiled_ms(torch, fwd, f"{label} bs{BATCH} fp32 forward")
            row["forward"]["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        row["k1_launches"] = U.fused_uconv_block.launches
        if row["k1_launches"]:
            raise RuntimeError(f"{label} launched K1 {row['k1_launches']} times")
        del model
        row["card_vs_cpu"] = card_vs_cpu_forward(torch, np, model_type, hp, weights, device,
                                                 label)
        if device == "cuda":
            row["train_step"] = zoo_train_step(torch, np, model_type, hp, weights, device,
                                               label)
        res[model_type] = row

    # remat_blocks on Improved U16/512 (fma blocks, the training default)
    weights = zoo_weights(torch, "relu", remat_hp)
    batch = torch.from_numpy(_brown_batch(np, BATCH, 2, t, 5)).to(device)
    grads, remat = {}, {}
    for on in (False, True):
        model = zoo_model(torch, "relu", remat_hp, weights, device, block_impl="fma",
                          remat_blocks=on)
        tr = Trainer(model, TrainerConfig(loss_clamp=0.0))
        state = tr.init_state()
        tr.compute_gradients(state, batch, draw_remix(torch.Generator().manual_seed(7),
                                                      BATCH, 2))
        grads[on] = {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}
        if device == "cuda":
            gen = torch.Generator().manual_seed(0)
            step = lambda: tr.train_step(state, batch, draw_remix(gen, BATCH, 2))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(torch, step, warmup=2, reps=ZOO_STEP_REPS)
            remat[on] = dict(ms=ms, peak_mib=torch.cuda.max_memory_allocated() / 2**20)
        del model, tr, state
        if device == "cuda":
            torch.cuda.empty_cache()
    rel = max(float((grads[True][n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
              for n, g in grads[False].items())
    print(f"remat_blocks on Improved U16/512 bs{BATCH} fma fp32: grads against the plain "
          f"step, max |delta| / max |grad| over the tensors {rel:.3e}"
          + "".join(f"; {'with' if on else 'without'}: step {r['ms']:.3f} ms, peak "
                    f"{r['peak_mib']:.0f} MiB" for on, r in remat.items()))
    if not rel <= 1e-4:
        raise RuntimeError(f"remat_blocks grads differ from the plain ones by {rel:.3e}")
    res["remat"] = dict(grad_max_rel=rel, **{("with" if k else "without"): v
                                             for k, v in remat.items()})
    return res


def zoo_cli_phase(torch, np, tmp: str, device: str = "cuda", types=None) -> dict:
    """``sudo-torch-separate`` of one wav on the card for causal, softmax and
    attention_v2, from a ``.pt`` and from a msgpack TrainState of the same
    weights: identical int16, finite and not silent, 0 K1 launches."""
    from scipy.io import wavfile

    from sudo_rm_rf_tpu_torch.cli.separate import main as separate_main
    from sudo_rm_rf_tpu_torch.convert import save_train_state
    from sudo_rm_rf_tpu_torch.ops import uconv as U
    from sudo_rm_rf_tpu_torch.train import Trainer

    types = types or {"causal": CAUSAL, "softmax": V1, "attention_v2": ATTENTIVE}
    n = int(6.0 * FS)
    tt = np.arange(n) / FS
    mix = 0.3 * np.sin(2 * np.pi * 220 * tt) + 0.2 * np.sin(2 * np.pi * 1330 * tt)
    wav = os.path.join(tmp, "zoo_mix.wav")
    wavfile.write(wav, FS, (mix * 32767).astype(np.int16))
    res = {}
    for model_type, hp in types.items():
        weights = zoo_weights(torch, model_type, hp)
        pt, mp = os.path.join(tmp, f"{model_type}.pt"), os.path.join(tmp, f"{model_type}_ckpt")
        torch.save(weights, pt)
        save_train_state(Trainer(zoo_model(torch, model_type, hp, weights, "cpu")).init_state(),
                         mp)
        outs, secs = {}, {}
        U.fused_uconv_block.launches = 0
        for kind, ckpt in (("pt", pt), ("msgpack", mp)):
            t0 = time.perf_counter()
            run_cli(separate_main, ["--checkpoint", ckpt, "--model_type", model_type,
                                    "--input", wav, "--out_dir",
                                    os.path.join(tmp, f"sep_{model_type}_{kind}"),
                                    "--device", device, "--batch_chunks", str(BATCH),
                                    "-fs", str(FS), "--chunk_seconds", str(CHUNK_SECONDS),
                                    *hp_argv(hp)])
            secs[kind] = time.perf_counter() - t0
            outs[kind] = [wavfile.read(os.path.join(
                tmp, f"sep_{model_type}_{kind}", f"zoo_mix_s{s}.wav"))[1] for s in (1, 2)]
        launches = U.fused_uconv_block.launches
        identical = all(np.array_equal(a, b) for a, b in zip(outs["pt"], outs["msgpack"]))
        ok = all(o.shape == (n,) and np.abs(o).max() > 0 for o in outs["pt"])
        print(f"CLI {model_type}: one {n / FS:.0f} s file from the .pt / the msgpack in "
              f"{secs['pt']:.2f} / {secs['msgpack']:.2f} s; int16 identical: {identical}; "
              f"K1 launches {launches}")
        if not (identical and ok) or launches:
            raise RuntimeError(f"CLI {model_type}: identical {identical}, outputs ok {ok}, "
                               f"K1 launches {launches}")
        res[model_type] = dict(cli_s=secs, identical=identical, k1_launches=launches)
    return res


def baselines_phase(torch, np, tmp: str, device: str = "cuda", zoo: dict = BASELINES,
                    bench=BASELINE_BENCH, radam_hp: dict = RADAM_HP,
                    radam_files: int = RADAM_FILES, radam_seconds: float = RADAM_SECONDS,
                    radam_val_files: int = 4) -> dict:
    """The baselines at their published configurations: the bs4 fp32
    forward (ms, idle share, launches, peak), card against CPU on one
    forward, one bs4 ``radam_cosine`` train step each (SepFormer also at
    bs1, its published batch), K1 counted 0 times over each model's path;
    ``sudo-torch-bench`` at the JAX zoo's baseline rows (bs1 and bs4, fp32);
    then ``sudo-torch-train --optimizer radam_cosine`` on Improved U1/512 (the
    U16/512 widths, one block) for one epoch and a resumed second (counts
    checked, 0 K1 launches)."""
    from sudo_rm_rf_tpu_torch.cli.bench import main as bench_main
    from sudo_rm_rf_tpu_torch.cli.train import main as train_main
    from sudo_rm_rf_tpu_torch.data.synthetic import write_wham_corpus
    from sudo_rm_rf_tpu_torch.ops import uconv as U

    res = {}
    t = int(CHUNK_SECONDS * FS)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((BATCH, 1, t))
                         .astype(np.float32)).to(device)
    for model_type, hp in zoo.items():
        weights = zoo_weights(torch, model_type, hp)
        n_params = sum(v.numel() for v in weights.values())
        model = zoo_model(torch, model_type, hp, weights, device).eval()

        def fwd():
            with torch.inference_mode():
                return model(x)

        # the model's path (its forward, the CPU comparison and its train
        # steps), with the K1 count at 0 just before it
        row = dict(params_m=n_params / 1e6)
        U.fused_uconv_block.launches = 0
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        out = fwd()
        if out.shape != (BATCH, 2, t) or not torch.isfinite(out).all():
            raise RuntimeError(f"{model_type} forward: shape {tuple(out.shape)}")
        label = f"{model_type} ({n_params / 1e6:.2f} M params)"
        if device == "cuda":
            row["forward"] = profiled_ms(torch, fwd, f"{label} bs{BATCH} fp32 forward")
            row["forward"]["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        del model, out
        row["card_vs_cpu"] = card_vs_cpu_forward(torch, np, model_type, hp, weights, device,
                                                 model_type)
        if device == "cuda":
            row["train_step"] = zoo_train_step(torch, np, model_type, hp, weights, device,
                                               model_type, optimizer="radam_cosine")
            if model_type == "sepformer":
                row["train_step_bs1"] = zoo_train_step(
                    torch, np, model_type, hp, weights, device, model_type, batch_size=1,
                    optimizer="radam_cosine")
        row["k1_launches"] = U.fused_uconv_block.launches
        if row["k1_launches"]:
            raise RuntimeError(f"{model_type} launched K1 {row['k1_launches']} times")
        res[model_type] = row
        del weights

    # the JAX zoo's baseline rows through sudo-torch-bench
    U.fused_uconv_block.launches = 0
    t0 = time.perf_counter()
    lines = run_cli(bench_main, ["--models", *bench, "--batch_sizes", "1", str(BATCH),
                                 "--device", device])
    rows = [json.loads(ln) for ln in lines.splitlines() if ln.startswith("{")]
    res["bench"] = dict(rows=rows, seconds=time.perf_counter() - t0,
                        k1_launches=U.fused_uconv_block.launches)
    print(f"sudo-torch-bench baselines: {len(rows)} rows in {res['bench']['seconds']:.1f} s, "
          f"K1 launches {res['bench']['k1_launches']}")
    if len(rows) != 2 * len(bench) or res["bench"]["k1_launches"] or any(
            not r["secs_per_batch"] > 0 or not r["gflops_per_batch"] > 0
            or (device == "cuda" and "mfu_pct" not in r) for r in rows):
        raise RuntimeError(f"sudo-torch-bench baselines: {rows}")

    # sudo-torch-train --optimizer radam_cosine: one epoch, then a resumed one
    t0 = time.perf_counter()
    root = write_wham_corpus(os.path.join(tmp, "radam_wham"), radam_files, radam_val_files,
                             radam_seconds, FS, seed=RADAM_SEED)
    corpus_s = time.perf_counter() - t0
    argv = _train_argv("relu", radam_hp, root, tmp, "radam", device) + [
        "-bs", "1", "--audio_timelength", str(radam_seconds), "--optimizer", "radam_cosine"]
    U.fused_uconv_block.launches = 0
    t0 = time.perf_counter()
    out = run_cli(train_main, argv + ["--n_epochs", "1"])
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out += run_cli(train_main, argv + ["--n_epochs", "2", "--resume"])
    resume_s = time.perf_counter() - t0
    cli_launches = U.fused_uconv_block.launches
    epochs = re.findall(r"^epoch (\d+)/\d+ tr_loss=(\S+) val_SISDRi=(\S+)", out, re.M)
    resumed = re.search(r"resumed from epoch (\d+): step (\d+), Adam step (\d+)", out)
    losses = np.concatenate([np.load(os.path.join(tmp, "logs", "radam", "tr_loss",
                                                  f"epoch_{e}.npy")) for e in (1, 2)])
    counts = checkpoint_counts(os.path.join(tmp, "ckpt", "radam", "relu_epoch_2"))
    print(f"sudo-torch-train --optimizer radam_cosine (U{radam_hp['num_blocks']}/"
          f"{radam_hp['enc_num_basis']}, bs1, {radam_seconds} s): corpus of {radam_files} "
          f"files in {corpus_s:.1f} s; one epoch in {first_s:.1f} s, the resumed one in "
          f"{resume_s:.1f} s; {resumed and resumed.group(0)}; last checkpoint's step, RAdam "
          f"and schedule counts {counts}; K1 launches {cli_launches}")
    if ([int(e) for e, _, _ in epochs] != [1, 2] or resumed is None
            or tuple(map(int, resumed.groups())) != (1, radam_files, radam_files)
            or counts != (2 * radam_files,) * 3 or len(losses) != 2 * radam_files
            or not np.isfinite(losses).all() or cli_launches):
        raise RuntimeError(f"radam_cosine CLI: epochs {epochs}, resumed {resumed}, counts "
                           f"{counts}, {len(losses)} losses, K1 launches {cli_launches}")
    res["radam_cli"] = dict(first_epoch_s=first_s, resumed_epoch_s=resume_s,
                            first_loss=float(losses[0]), last_loss=float(losses[-1]),
                            val_sisdri=[float(v) for _, _, v in epochs], k1_launches=cli_launches)
    return res


def k1_wide_check(torch, U) -> dict:
    """K1 at the u36_wide block (Co=512, Ci=2048, T=3200, depth 5) at B=1 and
    4, with each pyramid, against ``uconv_block_levelwise`` with the same
    pyramid on the card, and two calls bit-identical. fp32: within rtol =
    atol = 1e-4. bf16: the outputs outside 1e-4 are counted; where there are
    any, they must be bf16 rounding flips under the bf16 pyramid's rule
    (PYRAMID_*). Each row: the time (CUDA events) and the plain version's, K1's bound, the
    ``torch.matmul`` yardstick of its two products and, at B=4, its parts."""
    from sudo_rm_rf_tpu_torch.utils.benchmark import k1_bound

    rows = {}
    for b in WIDE_BATCHES:
        co, ci, t, depth = U36_WIDE_BLOCK
        p = block_params(torch, depth, ci, co, seed=0)
        x = torch.randn(b, co, t, generator=torch.Generator().manual_seed(1)).cuda()
        acc_in = torch.randn(b, ci, t, generator=torch.Generator().manual_seed(2)).cuda()
        lib_ms = time_ms(torch, lambda: (torch.matmul(p["proj_w"], x),
                                         torch.matmul(p["res_w"], acc_in)), reps=10)
        bound = k1_bound(b, co, ci, t, depth)
        for pyramid, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            label = f"K1 u36_wide {pyramid} pyramid {(b, co, ci, t, depth)}"
            got = U.fused_uconv_block(x, p, depth, dt)
            torch.cuda.synchronize()
            want = U.uconv_block_levelwise(x, p, depth, dt)
            diff = (got - want).abs()
            err = diff.max().item()
            outside = int((diff > 1e-4 + 1e-4 * want.abs()).sum())
            snr = _snr_db(torch, want - x, got - x)
            past = int((diff > PYRAMID_MAX_ABS).sum())
            plain = ""
            if pyramid == "fp32":
                ok = outside == 0
            else:
                ok = outside == 0 or (snr >= PYRAMID_MIN_DB and err <= PYRAMID_FLIP_MAX
                                      and past <= PYRAMID_FLIP_SHARE * diff.numel())
                # what bf16 rounding flips alone give: the plain version in
                # fp32 against itself in float64, with the same bf16 store
                want64 = U.uconv_block_levelwise(
                    x.double(), {k: v.double() for k, v in p.items()}, depth, dt)
                gap = (want.double() - want64).abs()
                plain_outside = int((gap > 1e-4 + 1e-4 * want64.abs()).sum())
                plain = (f"; the plain version in fp32 against itself in float64: max "
                         f"{gap.max().item():.3e}, {plain_outside} outside 1e-4")
                del want64, gap
            del want
            print(f"{label}: vs uconv_block_levelwise max_abs_err {err:.3e}, {outside} of "
                  f"{diff.numel()} outputs outside rtol = atol = 1e-4, {snr:.2f} dB on "
                  f"(out - x)" + plain)
            if not ok:
                raise RuntimeError(f"{label}: {outside} outputs outside 1e-4, max |delta| "
                                   f"{err:.3e}, {snr:.2f} dB")
            if not torch.equal(got, U.fused_uconv_block(x, p, depth, dt)):
                raise RuntimeError(f"{label}: two calls differ")
            del got, diff
            call = lambda dt=dt: U.fused_uconv_block(x, p, depth, dt)
            ms = time_ms(torch, call, reps=10)
            plain_ms = time_ms(torch, lambda dt=dt: U.uconv_block_levelwise(x, p, depth, dt),
                               warmup=1, reps=3)
            parts = device_ms_by_kernel(torch, call, 5) if b == BATCH else {}
            print(f"{label}: {ms:.4f} ms (median of 10), plain {plain_ms:.3f} ms (median of "
                  f"3); torch.matmul of its two products "
                  f"{lib_ms:.4f} ms; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
                  f"share {bound['bound_ms'] / ms:.1%})"
                  + ("; device ms by part: " + (", ".join(
                      f"{k} {parts[k]:.4f}" for k in K1_PARTS if k in parts) or "not measured")
                     if b == BATCH else ""))
            rows[f"{pyramid}_b{b}"] = dict(
                shape=f"B,Co,Ci,T,depth={b},{co},{ci},{t},{depth}", pyramid=pyramid,
                max_abs_err=err, outside_1e_4=outside, outputs=b * co * t,
                snr_vs_plain_db=snr, ms=ms, plain_ms=plain_ms,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"], library_ms=lib_ms,
                library_call="torch.matmul of the proj and res products",
                parts_ms={k: parts.get(k) for k in K1_PARTS} if parts else None,
                bit_identical=True)
        del p, x, acc_in
        torch.cuda.empty_cache()
    return rows


# (B, Co, Ci, T, depth) of every K1 call of the main paths, for the GEMM
# route check: the flagship at bs32 (u16-batch32) and bs8 (u16-recordings),
# U36 at bs4 (u36-b4096-batch4), GroupComm's folded bs32 (gc-u16-batch32),
# u36_wide at B=4, the U8/256 block and the 10-minute block
GEMM_ROUTE_SHAPES = [(32, 256, 512, 3200, 5), (8, 256, 512, 3200, 5), U36_BLOCK,
                     (32 * GROUPCOMM["group_size"], 16, 32, 3200, 5),
                     (BATCH,) + U36_WIDE_BLOCK, CONVERGENCE_BLOCK, LONGFORM_BLOCK]


def k1_gemm_routes(torch, U, lib) -> dict:
    """K1's two 1x1 products at GEMM_ROUTE_SHAPES: the route of each (the
    library's ``gemm_wide`` must equal ``U.gemm_wide``), the wide GEMM
    launches a call (``fused_uconv_block.gemm_wide_launches``: 2 where
    both products are wide, 0 at GroupComm's folded shape) and the GEMMs'
    device ms a call by route."""
    rows = {}
    for shape in GEMM_ROUTE_SHAPES:
        b, co, ci, t, depth = shape
        routes = {name: bool(lib.gemm_wide(m, k)) for name, (m, k) in
                  (("proj", (ci, co)), ("res", (co, ci)))}
        mirror = {"proj": U.gemm_wide(ci, co), "res": U.gemm_wide(co, ci)}
        if routes != mirror:
            raise RuntimeError(f"GEMM routes at {shape}: library {routes}, ops/uconv.py {mirror}")
        p = block_params(torch, depth, ci, co, seed=0)
        x = torch.randn(b, co, t, generator=torch.Generator().manual_seed(1)).cuda()
        before = U.fused_uconv_block.gemm_wide_launches
        U.fused_uconv_block(x, p, depth)
        torch.cuda.synchronize()
        wide = U.fused_uconv_block.gemm_wide_launches - before
        if wide != sum(routes.values()):
            raise RuntimeError(f"GEMM routes at {shape}: gemm_wide_launches counted {wide}")
        ms = {}  # by route: wide::gemm_kernel, or the narrow gemm_kernel
        for name, v in device_ms_by_kernel(torch, lambda: U.fused_uconv_block(x, p, depth),
                                           3 if t > 100000 else 10, by_part=False).items():
            if re.search(r"\bgemm_kernel\b", name):
                route = "wide" if "wide::" in name else "narrow"
                ms[route] = ms.get(route, 0.0) + v
        print(f"K1 GEMM routes {shape}: proj {'wide' if routes['proj'] else 'narrow'}, res "
              f"{'wide' if routes['res'] else 'narrow'}, gemm_wide_launches {wide} a call; "
              "GEMM device ms a call: " + (", ".join(f"{k} {v:.4f}" for k, v in sorted(ms.items()))
                                           or "not measured (no device time in the trace)"))
        rows[",".join(map(str, shape))] = dict(routes=routes, gemm_wide_launches=wide,
                                               gemm_ms=ms or None)
        del p, x
        torch.cuda.empty_cache()
    return rows


def ladder_floor_ms(b: int, ci: int, t: int, depth: int, bf16: bool) -> list:
    """Least ms of each ladder level at 3.35 TB/s: its fp32 input read once
    and its outputs written once (fp32; bf16, and in fp32 for the next level
    but the last)."""
    out = []
    for k in range(depth):
        store = 2 + 4 * (k + 1 < depth) if bf16 else 4
        out.append(1e3 * b * ci * (4 * (t >> max(k - 1, 0)) + store * (t >> k)) / HBM_BYTES_PER_S)
    return out


def k1_ladder_check(torch, U, lib) -> dict:
    """K1 at every layout of the ladder (LADDER_SHAPES), with each pyramid,
    against ``uconv_block_levelwise`` with the same pyramid on the card, and
    two calls bit-identical. fp32: within rtol = atol = 1e-4. bf16: the
    same, or bf16 rounding flips under the bf16 pyramid's rule (PYRAMID_*),
    whose share of outputs past PYRAMID_MAX_ABS may rise to what the plain
    version in fp32 gives against itself in float64 at that shape (at bs32
    the share, set at B=4, is below that: 295 outputs past it against 2,491
    for the plain version, on the tree before this ladder too).
    The library's work a warp (``ladder_tiles``) must equal
    ``U.ladder_work``'s, and ``ladder_levels_tiled`` must count the levels
    with more than one (non-zero at the 10-minute block). Each row: K1's
    time (CUDA events), each level's ladder time beside its byte floor (its
    input read and its outputs written once at 3.35 TB/s) and the fold
    launches a call (torch.profiler)."""
    rows = {}
    for shape in LADDER_SHAPES:
        b, co, ci, t, depth = shape
        lens = [t >> k for k in range(depth)]
        work = [U.ladder_tiles(lib, b * ci, n) for n in lens]
        mirror = [(-(-n // tile), group, tile)
                  for n, (group, tile) in ((n, U.ladder_work(b * ci, n)) for n in lens)]
        if work != mirror:
            raise RuntimeError(f"ladder work at {shape}: library {work}, ops/uconv.py {mirror}")
        tiles = [w[0] for w in work]
        p = block_params(torch, depth, ci, co, seed=0)
        x = torch.randn(b, co, t, generator=torch.Generator().manual_seed(1)).cuda()
        for pyramid, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            label = f"K1 ladder {pyramid} pyramid {shape}"
            before = U.fused_uconv_block.ladder_levels_tiled
            got = U.fused_uconv_block(x, p, depth, dt)
            torch.cuda.synchronize()
            tiled = U.fused_uconv_block.ladder_levels_tiled - before
            if tiled != sum(n > 1 for n in tiles) or (shape == LONGFORM_BLOCK and tiled == 0):
                raise RuntimeError(f"{label}: ladder_levels_tiled counted {tiled}, tiles {tiles}")
            want = U.uconv_block_levelwise(x, p, depth, dt)
            diff = (got - want).abs()
            err = diff.max().item()
            outside = int((diff > 1e-4 + 1e-4 * want.abs()).sum())
            snr = _snr_db(torch, want - x, got - x)
            past, plain = int((diff > PYRAMID_MAX_ABS).sum()), ""
            ok = outside == 0
            if pyramid == "bf16":
                # what bf16 rounding flips alone give at this shape: the plain
                # version in fp32 against itself in float64, with the same store
                want64 = U.uconv_block_levelwise(
                    x.double(), {k: v.double() for k, v in p.items()}, depth, dt)
                plain_past = int(((want.double() - want64).abs() > PYRAMID_MAX_ABS).sum())
                del want64
                ok = ok or (snr >= PYRAMID_MIN_DB and err <= PYRAMID_FLIP_MAX and past
                            <= max(PYRAMID_FLIP_SHARE * diff.numel(), plain_past))
                plain = (f", {past} past {PYRAMID_MAX_ABS} (the plain version in fp32 against "
                         f"itself in float64: {plain_past})")
            print(f"{label}: (tiles a row, rows a warp, tile) {work}; vs "
                  f"uconv_block_levelwise max_abs_err "
                  f"{err:.3e}, {outside} of {diff.numel()} outputs outside rtol = atol = 1e-4, "
                  f"{snr:.2f} dB on (out - x)" + plain)
            if not ok:
                raise RuntimeError(f"{label}: {outside} outputs outside 1e-4, max |delta| "
                                   f"{err:.3e}, {snr:.2f} dB")
            if not torch.equal(got, U.fused_uconv_block(x, p, depth, dt)):
                raise RuntimeError(f"{label}: two calls differ")
            del got, want, diff
            call = lambda dt=dt: U.fused_uconv_block(x, p, depth, dt)  # noqa: E731
            ms = time_ms(torch, call, warmup=2, reps=10)
            level_ms, folds = ladder_level_ms(torch, call, depth, 5)
            floor_ms = ladder_floor_ms(b, ci, t, depth, pyramid == "bf16")
            print(f"{label}: {ms:.4f} ms (median of 10); ladder device ms a level "
                  + (", ".join(f"{m:.4f} (floor {f:.4f})" for m, f in zip(level_ms, floor_ms))
                     + f", sum {sum(level_ms):.4f} (floor {sum(floor_ms):.4f}, "
                     f"{sum(floor_ms) / sum(level_ms):.1%} of HBM bandwidth); fold_kernel "
                     f"launches a call {folds:g}" if level_ms else "not measured"))
            rows[f"{pyramid} " + ",".join(map(str, shape))] = dict(
                shape=f"B,Co,Ci,T,depth={b},{co},{ci},{t},{depth}", pyramid=pyramid,
                work=work, ladder_levels_tiled=tiled, max_abs_err=err,
                outside_1e_4=outside, snr_vs_plain_db=snr, ms=ms, ladder_level_ms=level_ms,
                ladder_floor_ms=floor_ms, fold_launches=folds, bit_identical=True)
        del p, x
        torch.cuda.empty_cache()
    return rows


def k1_long_check(torch, U, lib, shape=LONGFORM_BLOCK) -> dict:
    """K1 at the 10-minute block shape against ``uconv_block_reference`` on
    the card: dB on the block's change (out - x), its CUDA-event time beside
    the plain version's, the ``torch.matmul`` yardstick of its two products,
    and its bound."""
    from sudo_rm_rf_tpu_torch.utils.benchmark import k1_bound

    b, co, ci, t, depth = shape
    p = block_params(torch, depth, ci, co, seed=0)
    x = torch.randn(b, co, t, generator=torch.Generator().manual_seed(1)).cuda()
    got = U.fused_uconv_block(x, p, depth)
    torch.cuda.synchronize()
    want = U.uconv_block_reference(x, p, depth)
    err = (got - want).abs().max().item()
    db = _snr_db(torch, want - x, got - x)
    del want, got
    ms = time_ms(torch, lambda: U.fused_uconv_block(x, p, depth), warmup=2, reps=10)
    plain_ms = time_ms(torch, lambda: U.uconv_block_reference(x, p, depth), warmup=1, reps=3)
    acc_in = torch.randn(b, ci, t, generator=torch.Generator().manual_seed(2)).cuda()
    lib_ms = time_ms(torch, lambda: (torch.matmul(p["proj_w"], x),
                                     torch.matmul(p["res_w"], acc_in)), warmup=2, reps=10)
    bound = k1_bound(b, co, ci, t, depth)
    parts = device_ms_by_kernel(torch, lambda: U.fused_uconv_block(x, p, depth), 5)
    # a trace that lost launches (seen late in a whole run) is not a reading
    covered = sum(parts.values()) / ms
    print(f"K1 long shape device ms per call by part (torch.profiler, 5 calls): "
          + (", ".join(f"{k} {parts[k]:.3f}" for k in K1_PARTS if k in parts)
             or "not measured (no device time in the trace)")
          + f"; the parts sum to {covered:.1%} of the CUDA-event time")
    if not 0.9 <= covered <= 1.1:
        print("K1 long shape parts: not measured (the trace does not cover the call)")
        parts = {}
    ws_gb = 4 * lib.uconv_workspace_floats(b, co, ci, t, depth, 0) / 1e9
    print(f"K1 long shape {shape}: max_abs_err {err:.3e}, {db:.2f} dB on the block's change "
          f"against uconv_block_reference; {ms:.3f} ms (median of 10), plain {plain_ms:.3f} "
          f"ms, torch.matmul of its two products {lib_ms:.3f} ms; bound {bound['bound_ms']:.4f} "
          f"ms ({bound['bound_by']}; share {bound['bound_ms'] / ms:.1%}); workspace "
          f"{ws_gb:.2f} GB a call (from the shapes)")
    if not db >= MIN_FIDELITY_DB:
        raise RuntimeError(f"K1 at {shape}: {db:.2f} dB < {MIN_FIDELITY_DB} dB")
    return dict(shape=f"B,Co,Ci,T,depth={b},{co},{ci},{t},{depth}", max_abs_err=err,
                fidelity_db=db, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_call="torch.matmul of the proj and res products",
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                parts_ms={k: parts.get(k) for k in K1_PARTS})


def tac_module(torch, n: int, seed: int, device: str = "cuda"):
    """A seeded TAC module of n channels a group, its slopes, gains and
    shifts drawn around their init."""
    from sudo_rm_rf_tpu_torch.models.groupcomm_sudormrf import TAC

    g = torch.Generator().manual_seed(seed)
    tac = TAC(n, 3 * n, generator=g).eval()
    with torch.no_grad():
        for name, p in tac.named_parameters():
            if name.endswith(("gamma", "beta")) or p.numel() == 1:
                p.add_(0.1 * (2 * torch.rand(p.shape, generator=g) - 1))
    return tac.to(device)


def tac_floors_ms(b: int, g: int, n: int, t: int) -> dict:
    """Least ms of TAC's passes: bytes (each fp32 input read once, each
    output written once, at 3.35 TB/s) and the mix pass's arithmetic on the
    fp32 pipes, once (y kept) and with y computed twice (the kernel's)."""
    h, xb = 3 * n, 4 * b * g * n * t
    flops = 2 * b * t * (g * 2 * h * n + h * h + n * h)
    return dict(mix_bytes=1e3 * 2 * xb / HBM_BYTES_PER_S, norm_bytes=1e3 * 3 * xb / HBM_BYTES_PER_S,
                tac_bytes=1e3 * 5 * xb / HBM_BYTES_PER_S,
                mix_flops=1e3 * flops / FP32_FLOPS_PER_S,
                mix_flops_recompute=1e3 * (flops + 2 * b * t * g * h * n) / FP32_FLOPS_PER_S)


def tac_check(torch, lib) -> dict:
    """TAC's kernel (``ops/tac.py::fused_tac``, ``csrc/tac.cu``) against its
    plain version (``tac_plain``, ``_tac_fast``'s arithmetic) on the card at
    TAC_SHAPES within rtol 1e-4, atol 1e-5; two calls bit-identical; its
    launches a call (2, or 3 with the fold launch). At TAC_TIMED: its time
    (CUDA events), each pass's device time (``torch.profiler``) beside its
    floors, the plain version's time, and the ``torch.matmul`` time of its
    three products (W_in x, W_oy y, W_mean mean), a yardstick the port never
    calls."""
    from sudo_rm_rf_tpu_torch.ops import tac as T

    rows = {}
    for shape in TAC_SHAPES:
        b, g, n, t = shape
        tac = tac_module(torch, n, seed=n)
        x = torch.randn(shape, generator=torch.Generator().manual_seed(1)).cuda()
        tiles = lib.tac_tiles(t)
        label = f"TAC {shape}"
        with torch.no_grad():
            before = T.fused_tac.launches
            got = T.fused_tac(tac, x)
            torch.cuda.synchronize()
            launches = T.fused_tac.launches - before
            want = T.tac_plain(tac, x)
            diff = (got - want).abs()
            err = diff.max().item()
            outside = int((diff > 1e-5 + 1e-4 * want.abs()).sum())
            same = torch.equal(got, T.fused_tac(tac, x))
        print(f"{label}: vs tac_plain max_abs_err {err:.3e}, {outside} of {diff.numel()} "
              f"outputs outside rtol 1e-4 atol 1e-5; {launches} launches a call ({tiles} tiles "
              f"a plane); two calls {'bit-identical' if same else 'differ'}")
        if outside or not same or launches != (3 if tiles > 256 else 2):
            raise RuntimeError(f"{label}: {outside} outside, bit-identical {same}, "
                               f"{launches} launches with {tiles} tiles")
        row = dict(shape=f"B,G,n,T={b},{g},{n},{t}", max_abs_err=err, outside_tol=outside,
                   launches=launches, tiles=tiles, bit_identical=True)
        del got, want, diff
        if shape in TAC_TIMED:
            with torch.no_grad():
                call = lambda: T.fused_tac(tac, x)  # noqa: E731
                ms = time_ms(torch, call, warmup=3, reps=20)
                by_name = device_ms_by_kernel(torch, call, 10, by_part=False)
                passes = {}
                for name, v in by_name.items():
                    m = re.search(r"\btac_(mix|fold|norm)_kernel\b", name)
                    key = m.group(1) if m else "other"
                    passes[key] = passes.get(key, 0.0) + v
                plain_ms = time_ms(torch, lambda: T.tac_plain(tac, x), warmup=1, reps=5)
                h = 3 * n
                w_in, w_mean = tac.TAC_input[0].weight, tac.TAC_mean[0].weight
                w_oy = tac.TAC_output[0].weight[:, :h]
                y = torch.randn(b * g, h, t, device="cuda")
                mean = torch.randn(b, h, t, device="cuda")
                xf = x.view(b * g, n, t)
                lib_ms = time_ms(torch, lambda: (torch.matmul(w_in, xf), torch.matmul(w_oy, y),
                                                 torch.matmul(w_mean, mean)), warmup=2, reps=10)
                del y, mean
            floors = tac_floors_ms(b, g, n, t)
            print(f"{label}: {ms:.4f} ms a call (CUDA events, median of 20), floor "
                  f"{floors['tac_bytes']:.4f} ms of bytes ({floors['tac_bytes'] / ms:.1%} of "
                  f"HBM bandwidth); device ms a call by pass (torch.profiler, 10 calls): "
                  + (", ".join(f"{k} {v:.4f}" for k, v in sorted(passes.items()))
                     or "not measured (no device time in the trace)")
                  + f"; mix floors {floors['mix_bytes']:.4f} ms of bytes, "
                  f"{floors['mix_flops']:.4f} ms of fp32 arithmetic "
                  f"({floors['mix_flops_recompute']:.4f} with y computed twice), norm floor "
                  f"{floors['norm_bytes']:.4f} ms of bytes; plain (tac_plain) {plain_ms:.3f} "
                  f"ms; torch.matmul of its three products {lib_ms:.4f} ms")
            row.update(ms=ms, pass_ms=passes, floors_ms=floors, plain_ms=plain_ms,
                       library_ms=lib_ms,
                       library_call="torch.matmul of W_in x, W_oy y and W_mean mean")
        rows[",".join(map(str, shape))] = row
        del tac, x
        torch.cuda.empty_cache()
    return rows


def longform_phase(torch, np, tmp: str, seed: int = 0, device: str = "cuda",
                   families: dict | None = None, seconds: float = LONGFORM_SECONDS,
                   cli_seconds: float = LONGFORM_CLI_SECONDS,
                   shards=LONGFORM_SHARDS) -> dict:
    """Exact long-form separation: one ``seconds`` 8 kHz mixture (made from
    ``seed``) through ``SequenceParallelSeparator`` for Improved and GroupComm
    U16/512: the one-rank K1 route in fp32 and with ``compute_dtype=
    "bfloat16"``, the one-rank plain shard body, ``LocalShards(n)`` for each
    n of ``shards``, and ``DistributedShards`` over a one-rank NCCL group
    (gloo on the CPU). Each run against the unsharded ``fma`` /
    ``fma_merged`` forward of the same padded signal in its compute dtype
    (>= 80 dB in fp32; >= BF16_GATE_DB for the bf16 route, which runs K1 in
    fp32 from bf16-rounded params while the plain bf16 forward computes in
    bf16), its seconds (a second call after a warm-up), peak memory and K1
    launches (16 a pass on the K1 routes, 0 elsewhere). Then K1 at the
    10-minute block shape, and ``sudo-torch-separate --mode seq_parallel``
    of a ``cli_seconds`` wav within 1 LSB of the Python API."""
    import datetime

    import torch.distributed as dist
    from scipy.io import wavfile

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.cli.separate import main as separate_main
    from sudo_rm_rf_tpu_torch.data.base import read_wav
    from sudo_rm_rf_tpu_torch.inference import sequence_parallel as sp
    from sudo_rm_rf_tpu_torch.models import fast_inference as fi
    from sudo_rm_rf_tpu_torch.ops import _build
    from sudo_rm_rf_tpu_torch.ops import uconv as U

    cuda = device == "cuda"
    families = families or {"relu": FLAGSHIP, "groupcomm_v2": GROUPCOMM}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def mixture(n, rng):
        tt = np.arange(n) / FS
        return (0.3 * np.sin(2 * np.pi * 220 * tt) + 0.2 * np.sin(2 * np.pi * 1330 * tt)
                + 0.05 * rng.standard_normal(n)).astype(np.float32)

    n = int(seconds * FS)
    mix = mixture(n, np.random.default_rng(seed))
    out = {"seconds": seconds, "seed": seed, "families": {}}
    dist.init_process_group("nccl" if cuda else "gloo",
                            store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        for model_type, hp in families.items():
            gc = model_type == "groupcomm_v2"
            tag = "GC U16/512" if gc else "U16/512"
            model = models.get_model(model_type, **hp, device=device,
                                     generator=torch.Generator().manual_seed(0)).eval()
            fast = fi.groupcomm_forward_fast if gc else fi.improved_forward_fast
            mean, std = float(mix.mean()), float(mix.std(ddof=1))
            refs, ref_s = {}, {}

            def reference(total, dtype=None):
                """The unsharded plain forward, in ``dtype``, of the signal
                padded to total samples (the shard counts may pad
                differently: GlobLN sees the pad), de-standardized as the
                separator does."""
                key = (total, dtype)
                if key not in refs:
                    padded = np.zeros(total, np.float32)
                    padded[:n] = (mix - mean) / (std + 1e-9)
                    sync()
                    t0 = time.perf_counter()
                    ref = fast(model, torch.from_numpy(padded).to(device)[None, None],
                               impl="fma_merged" if gc else "fma", compute_dtype=dtype)
                    sync()
                    ref_s[f"{total}_{dtype or 'float32'}"] = time.perf_counter() - t0
                    refs[key] = ref[0, :, :n].cpu().numpy().astype(np.float64) * std + mean
                    del ref
                return refs[key]

            runs = {"kernel": dict(impl="kernel"),
                    "kernel_bf16": dict(impl="kernel", compute_dtype="bfloat16"),
                    "fma": dict(impl="fma"),
                    **{f"local{k}": dict(comm=sp.LocalShards(k)) for k in shards},
                    # the shard body over the process group: its collectives
                    # launch on the card (one rank would take the K1 route)
                    "distributed1": dict(comm=sp.DistributedShards(), impl="fma")}
            if not cuda:
                del runs["kernel"], runs["kernel_bf16"]
            rows = {}
            for label, kw in runs.items():
                sep = sp.SequenceParallelSeparator(model, **kw)
                sep.separate(mix)  # warm-up
                # the path, with the kernel count at 0 just before it
                U.fused_uconv_block.launches = 0
                if cuda:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                est = sep.separate(mix)
                sync()
                secs = time.perf_counter() - t0
                launches = U.fused_uconv_block.launches
                peak = torch.cuda.max_memory_allocated() / 2**20 if cuda else None
                if est.shape != (2, n) or not np.isfinite(est).all():
                    raise RuntimeError(f"longform {tag} {label}: bad output {est.shape}")
                dtype = kw.get("compute_dtype")
                total = sep._padded_len(n)
                fid = fidelity_db(np, reference(total, dtype), est.astype(np.float64))
                floor = MIN_FIDELITY_DB if dtype is None else BF16_GATE_DB
                want = hp["num_blocks"] if sep.route == "kernel" else 0
                rows[label] = dict(route=sep.route, n_shards=sep.comm.world,
                                   compute_dtype=dtype or "float32", seconds=secs,
                                   audio_s_per_s=seconds / secs, peak_mib=peak,
                                   k1_launches=launches, fidelity_db=fid)
                extra = ""
                if dtype is not None:
                    fid32 = fidelity_db(np, reference(total), est.astype(np.float64))
                    rows[label]["fidelity_fp32_db"] = fid32
                    extra = f" ({fid32:.2f} dB from the fp32 one)"
                print(f"longform {tag} {seconds:.0f} s {label}: route {sep.route}, "
                      f"{sep.comm.world} shard(s), {secs:.3f} s ({seconds / secs:.1f} audio-s/s)"
                      f", peak {peak if peak is None else round(peak)} MiB, {launches} K1 "
                      f"launches, {fid:.2f} dB from the unsharded plain "
                      f"{dtype or 'float32'} forward{extra}", flush=True)
                if launches != want:
                    raise RuntimeError(f"longform {tag} {label}: {launches} K1 launches, "
                                       f"expected {want}")
                if label.startswith("kernel") != (sep.route == "kernel"):
                    raise RuntimeError(f"longform {tag} {label}: route {sep.route}")
                if not fid >= floor:
                    raise RuntimeError(f"longform {tag} {label}: {fid:.2f} dB < {floor} dB")
                if cuda and label == "kernel":
                    # where the K1 route's pass goes: K1's parts, the rest by
                    # kernel name, and the device's idle share of the pass
                    call = lambda: sep.separate(mix)  # noqa: E731
                    parts = device_ms_by_kernel(torch, call, 1)
                    named = device_ms_by_kernel(torch, call, 1, by_part=False)
                    top = sorted(((k, v) for k, v in named.items() if not re.search(
                        r"\b(%s)_kernel\b" % "|".join(K1_PARTS), k)), key=lambda kv: -kv[1])[:6]
                    busy = sum(parts.values())
                    rows[label].update(device_ms=parts, busy_ms=busy,
                                       idle_share=1 - busy / (1e3 * secs),
                                       top_other_kernels_ms={k[:80]: v for k, v in top})
                    print(f"longform {tag} kernel pass device ms (torch.profiler): "
                          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(parts.items()))
                          + f"; busy {busy:.1f} of {1e3 * secs:.1f} ms, idle "
                          f"{1 - busy / (1e3 * secs):.1%}; top outside K1: "
                          + "; ".join(f"{k[:60]} {v:.2f}" for k, v in top))
                del sep, est
            out["families"][model_type] = dict(reference_s=list(ref_s.values()), runs=rows)
            del model, refs
    finally:
        dist.destroy_process_group()

    if cuda:
        out["k1_long"] = k1_long_check(torch, U, _build.load_kernels())

    # the CLI on a shorter wav, within 1 LSB of the Python API
    hp = families["relu"]
    model = models.get_model("relu", **hp, device=device,
                             generator=torch.Generator().manual_seed(0)).eval()
    ckpt = os.path.join(tmp, "relu.pt")
    torch.save(model.state_dict(), ckpt)
    wav = os.path.join(tmp, "long.wav")
    wavfile.write(wav, FS, (mixture(int(cli_seconds * FS), np.random.default_rng(seed + 1))
                            * 32767).astype(np.int16))
    out_dir = os.path.join(tmp, "separated_long")
    U.fused_uconv_block.launches = 0
    t0 = time.perf_counter()
    run_cli(separate_main, ["--checkpoint", ckpt, "--model_type", "relu", "--input", wav,
                            "--out_dir", out_dir, "--mode", "seq_parallel", "--device", device,
                            "-fs", str(FS), *hp_argv(hp)])
    sync()
    cli_s = time.perf_counter() - t0
    cli_launches = U.fused_uconv_block.launches
    api = sp.SequenceParallelSeparator(model).separate(read_wav(wav)[1])
    lsb = 0
    for s in (1, 2):
        got = wavfile.read(os.path.join(out_dir, f"long_s{s}.wav"))[1].astype(np.int32)
        want = api[s - 1] / max(1.0, float(np.abs(api[s - 1]).max()))
        lsb = max(lsb, int(np.abs(got - (want * 32767).astype(np.int32)).max()))
    print(f"longform CLI sudo-torch-separate --mode seq_parallel, {cli_seconds:.0f} s wav: "
          f"{cli_s:.2f} s, {cli_launches} K1 launches, {lsb} LSB from the Python API")
    if lsb > 1:
        raise RuntimeError(f"the seq_parallel CLI is {lsb} LSB from the Python API")
    if cli_launches != (hp["num_blocks"] if cuda else 0):
        raise RuntimeError(f"the seq_parallel CLI launched K1 {cli_launches} times")
    out["cli"] = dict(seconds=cli_s, k1_launches=cli_launches, lsb=lsb,
                      recording_s=cli_seconds)
    return out


# the parallel phase: the (data, model) grid of ranks at the bench's U16/512
PARALLEL_STEPS = 3  # part (a): steps of the one-NCCL-rank DP trainer
PARALLEL_TIMED = (1, 3)  # warm-up and timed steps of each part (b) step
PARALLEL_PROFILED = 2  # steps of a part (b) step's profile
PARALLEL_OLA_SECONDS = 60.0
PARALLEL_TRAIN_CUT = dict(n_train=8, n_val=4, seconds=CHUNK_SECONDS)
PARALLEL_MIN_PARAMS_DB = 80.0
PARALLEL_LOSS_ABS = 1e-4  # JAX's tolerance of a sharded step's loss
PARALLEL_NORM_REL = 1e-4
PARALLEL_NCCL_REL = 1e-6  # part (a): one NCCL rank against the plain trainer
# names of the collectives in a torch.profiler trace
COLLECTIVE_EVENT = re.compile(r"^(gloo|nccl):|^ncclDevKernel|^ncclKernel", re.I)


def _params_db(torch, got: dict, want: dict) -> float:
    """Fidelity (dB) of every param of ``got`` against ``want``, together."""
    num = sum(float((w.double() ** 2).sum()) for w in want.values())
    err = sum(float(((got[k].double().cpu() - w.double()) ** 2).sum())
              for k, w in want.items())
    return float("inf") if err == 0.0 else 10 * math.log10(num / err)


def _max_rel(torch, got: dict, want: dict) -> float:
    """Largest difference of a param, relative to its largest element."""
    return max(float((got[k].cpu() - w).abs().max() / w.abs().max().clamp_min(1e-30))
               for k, w in want.items())


def _timed_steps(torch, step, device: str, warmup: int, reps: int,
                 device_trace: bool = True, profiled: int = PARALLEL_PROFILED) -> dict:
    """Median ms of ``step`` (CUDA events on the card, the host clock on the
    CPU), and the share of the wall time the profiler puts in collectives
    over ``profiled`` steps: gloo's and NCCL's own host events and NCCL's
    kernels (the card is traced only with ``device_trace``); None where it
    records none."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.startswith("cuda")
    t_timing = time.perf_counter()
    if cuda:
        ms = time_ms(torch, step, warmup=warmup, reps=reps)
    else:
        for _ in range(warmup):
            step()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            step()
            ts.append(1e3 * (time.perf_counter() - t0))
        ms = statistics.median(ts)
    t_timing = time.perf_counter() - t_timing
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda and device_trace else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(profiled):
            step()
        if cuda:
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    # the trace's raw events: building key_averages' event tree over the
    # thousands of ops of a step took 7-20 s of host time a call
    coll, names, t_read = 0.0, {}, time.perf_counter()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if COLLECTIVE_EVENT.search(name):
            ms_ = e.duration_ns() / 1e6
            coll += ms_
            names[name[:60]] = names.get(name[:60], 0.0) + ms_ / profiled
    return dict(ms=ms, collective_share=(coll / wall) if names else None,
                collective_ms_by_event=names, timing_s=t_timing, profile_s=wall / 1e3,
                profile_read_s=time.perf_counter() - t_read)


@contextlib.contextmanager
def _launch_env(rank: int, world: int, port: int):
    """Inside: the environment a torchrun launch on one host gives rank
    ``rank`` of ``world`` (its rendezvous on localhost:``port``)."""
    env = dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _parallel_rank(rank: int, world: int, tmp: str, cuda: bool, port: int) -> None:
    """One of the two ranks of parts (b) to (e). Both ranks share the one
    card over gloo (NCCL refuses two ranks on one device): the rank joins
    through ``maybe_distributed_initialize(backend="gloo",
    share_device=True)`` in a torchrun environment. Writes what it measured
    to ``tmp/rank{rank}.json``."""
    import torch

    from sudo_rm_rf_tpu_torch.parallel import maybe_distributed_initialize, rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # as the parent's references
    case = torch.load(os.path.join(tmp, "case.pt"), weights_only=False)
    hp = case["hp"]
    t_start = time.perf_counter()
    with _launch_env(rank, world, port):
        kind = "cuda" if cuda else "cpu"
        if not maybe_distributed_initialize(backend="gloo", device=kind, share_device=True):
            raise RuntimeError("the rank did not join its launch")
        device = str(rank_device(kind, share_device=True))
        return _parallel_rank_parts(rank, tmp, case, hp, device, t_start)


def _parallel_rank_parts(rank, tmp, case, hp, device, t_start) -> None:
    """Parts (b) to (e) on this rank, joined to its group."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.cli.separate import main as separate_main
    from sudo_rm_rf_tpu_torch.cli.train import main as train_main
    from sudo_rm_rf_tpu_torch.inference import OverlapAddSeparator
    from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast
    from sudo_rm_rf_tpu_torch.ops import uconv as U
    from sudo_rm_rf_tpu_torch.parallel import make_mesh
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig

    out = {"backend": dist.get_backend(), "device": device,
           "part_seconds": {"init": time.perf_counter() - t_start}}
    t_part = time.perf_counter()

    def part_done(name):
        nonlocal t_part
        now = time.perf_counter()
        out["part_seconds"][name] = now - t_part
        t_part = now

    try:
        # (b) a DP step (2 rows a rank) and a (data 1, model 2) step with
        # storage and compute TP, each from the one-process step's weights,
        # batch and draws
        batch = torch.from_numpy(case["batch"]).to(device)
        U.fused_uconv_block.launches = 0
        for name, (n_data, n_model) in (("dp", (2, 1)), ("tp", (1, 2))):
            mesh = make_mesh(n_data, n_model)
            model = models.get_model("relu", **hp, block_impl="fma", device=device,
                                     tp_mesh=mesh if n_model > 1 else None)
            model.load_state_dict(case["weights"])
            tr = Trainer(model, TrainerConfig(shard_params=n_model > 1), mesh=mesh)
            if device.startswith("cuda"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            state = tr.init_state()
            part_done(f"b_{name}_build")
            _, m = tr.train_step(state, batch, case["draws"])
            if device.startswith("cuda"):
                torch.cuda.synchronize()
            part_done(f"b_{name}_first_step")
            whole = tr.whole_state_dict()
            row = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                       params_db=_params_db(torch, whole, case["after"]),
                       update_db=_params_db(
                           torch, {k: whole[k].cpu() - case["weights"][k] for k in whole},
                           {k: case["after"][k] - case["weights"][k] for k in whole}),
                       sharded=sorted(tr.shards.shapes) if tr.shards else [])
            # two processes on one card trace the host only: the gloo
            # collectives are host events
            part_done(f"b_{name}_check")
            row.update(_timed_steps(torch, lambda: tr.train_step(state, batch, case["draws"]),
                                    device, *PARALLEL_TIMED, device_trace=False))
            row["peak_mib"] = (torch.cuda.max_memory_allocated() / 2**20
                               if device.startswith("cuda") else None)
            out[name] = row
            part_done(f"b_{name}_timed")
            del model, tr, state
            if device.startswith("cuda"):
                torch.cuda.empty_cache()
        out["train_steps_k1"] = U.fused_uconv_block.launches
        # (c) DP overlap-add: each rank runs its chunks through K1
        mesh = make_mesh(2, 1)
        model = models.get_model("relu", **hp, device=device).eval()
        model.load_state_dict(case["weights"])
        sep = OverlapAddSeparator(model, chunk_samples=case["chunk"],
                                  batch_chunks=case["batch_chunks"], mesh=mesh,
                                  forward_fn=functools.partial(improved_forward_fast, model))
        U.fused_uconv_block.launches = 0
        t0 = time.perf_counter()
        est = sep.separate(case["ola_mix"])
        ola_s = time.perf_counter() - t0
        part_done("c")
        out["ola"] = dict(k1_launches=U.fused_uconv_block.launches, seconds=ola_s,
                          max_abs=float(np.abs(est - case["ola_ref"]).max()),
                          ref_peak=float(np.abs(case["ola_ref"]).max()))
        del model, sep
        # (d) sudo-torch-separate --mode seq_parallel over the two ranks
        U.fused_uconv_block.launches = 0
        t0 = time.perf_counter()
        run_cli(separate_main, case["separate_argv"])
        out["seq_cli"] = dict(seconds=time.perf_counter() - t0,
                              k1_launches=U.fused_uconv_block.launches)
        part_done("d")
        # (e) sudo-torch-train --n_model 2 over the two ranks
        U.fused_uconv_block.launches = 0
        t0 = time.perf_counter()
        run_cli(train_main, case["train_argv"])
        out["train_cli"] = dict(seconds=time.perf_counter() - t0,
                                k1_launches=U.fused_uconv_block.launches)
        part_done("e")
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()


def parallel_phase(torch, np, tmp: str, hp: dict = FLAGSHIP, device: str = "cuda",
                   ola_seconds: float = PARALLEL_OLA_SECONDS,
                   train_cut: dict = PARALLEL_TRAIN_CUT) -> dict:
    """Data and tensor parallelism over ``torch.distributed`` ranks at ``hp``
    (the bench's U16/512), seeded weights, WHAM bs4 4 s batches:

    (a) one NCCL rank: a DP ``Trainer`` (fp32, ``xla`` blocks) for
        PARALLEL_STEPS steps against the plain trainer with the same draws
        (loss and every param; the largest relative difference printed);
    (b) two ranks on the card (gloo: NCCL refuses two ranks on one device):
        a DP step (2 rows a rank) and a (data 1, model 2) step with storage
        and compute TP under ``fma``, each against the one-process step
        (loss, grad norm, params in dB), with each rank's step ms, the
        collectives' share of it and its peak memory;
    (c) DP overlap-add through K1 on the two ranks for a seeded
        ``ola_seconds`` mixture against the unsharded separator, K1 launches
        a rank;
    (d) ``sudo-torch-separate --mode seq_parallel`` over the two ranks on an
        ``ola_seconds`` wav against the one-rank CLI (int16, 1 LSB);
    (e) ``sudo-torch-train --n_model 2`` over the two ranks for one epoch on
        a synthetic WHAM corpus cut to ``train_cut``; rank 0's checkpoint
        loads into a one-process port model.
    Prints the backend of each part; runs with cuDNN's deterministic
    algorithms. Every failure raises."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from scipy.io import wavfile

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.cli.separate import main as separate_main
    from sudo_rm_rf_tpu_torch.data.synthetic import write_wham_corpus
    from sudo_rm_rf_tpu_torch.inference import OverlapAddSeparator
    from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast
    from sudo_rm_rf_tpu_torch.ops import uconv as U
    from sudo_rm_rf_tpu_torch.parallel import make_mesh, maybe_distributed_initialize
    from sudo_rm_rf_tpu_torch.train import Trainer, TrainerConfig, draw_remix

    cuda = device == "cuda"
    rank_device = "cuda:0" if cuda else "cpu"
    out = {}
    weights = models.get_model("relu", **hp, generator=torch.Generator().manual_seed(0)
                               ).state_dict()
    t = int(CHUNK_SECONDS * FS)
    batch = _brown_batch(np, BATCH, 2, t, seed=11)
    draws = draw_remix(torch.Generator().manual_seed(7), BATCH, 2)

    # cuDNN's deterministic algorithms, here and in the ranks: its default
    # backward convolutions sum in a run-dependent order, which Adam's first
    # steps amplify where a gradient is near 0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    # (a) one NCCL rank, joined as a torchrun launch of one rank joins: the
    # DP trainer against the plain one
    with _launch_env(0, 1, _free_port()):
        if not maybe_distributed_initialize(device=device):
            raise RuntimeError("(a) the rank did not join its launch")
    backend = dist.get_backend()
    try:
        mesh = make_mesh()
        runs = {}
        U.fused_uconv_block.launches = 0
        for name, m_ in (("dp", mesh), ("plain", None)):
            model = models.get_model("relu", **hp, block_impl="xla", device=device)
            model.load_state_dict(weights)
            tr = Trainer(model, TrainerConfig(), mesh=m_)
            state, gen, losses = tr.init_state(), torch.Generator().manual_seed(3), []
            on_card = torch.from_numpy(batch).to(device)
            for _ in range(PARALLEL_STEPS):
                _, m = tr.train_step(state, on_card, draw_remix(gen, BATCH, 2))
                losses.append(float(m["loss"]))
            runs[name] = (losses, {k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
            if name == "dp":
                runs["timed"] = _timed_steps(
                    torch, lambda: tr.train_step(state, on_card, draws), rank_device,
                    *PARALLEL_TIMED)
            del model, tr, state
        out["train_steps_k1"] = U.fused_uconv_block.launches
    finally:
        dist.destroy_process_group()
    loss_diff = max(abs(a - b) for a, b in zip(runs["dp"][0], runs["plain"][0]))
    rel = _max_rel(torch, runs["dp"][1], runs["plain"][1])
    out["a"] = dict(backend=backend, losses=runs["dp"][0], loss_abs_diff=loss_diff,
                    params_max_rel=rel, **runs["timed"])
    print(f"parallel (a) one {backend} rank, DP Trainer U16/512 bs4 fp32 xla, "
          f"{PARALLEL_STEPS} steps against the plain Trainer with the same draws (cuDNN "
          f"deterministic): losses "
          f"{', '.join(f'{v:.6f}' for v in runs['dp'][0])}, largest loss difference "
          f"{loss_diff:.3e}, largest relative param difference {rel:.3e}; a step "
          f"{runs['timed']['ms']:.3f} ms, collectives "
          + (f"{runs['timed']['collective_share']:.2%}" if runs["timed"]["collective_share"]
             is not None else "not in the trace")
          + f" ({runs['timed']['collective_ms_by_event']})")
    if loss_diff > PARALLEL_LOSS_ABS or rel > PARALLEL_NCCL_REL:
        raise RuntimeError(f"(a) the DP trainer parts from the plain one: {out['a']}")

    # the one-process references of (b) to (d)
    model = models.get_model("relu", **hp, block_impl="fma", device=device)
    model.load_state_dict(weights)
    tr = Trainer(model, TrainerConfig())
    state, on_card = tr.init_state(), torch.from_numpy(batch).to(device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _, m = tr.train_step(state, on_card, draws)
    one = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
    if abs(one["loss"]) >= TrainerConfig().loss_clamp:
        raise RuntimeError("the loss clamp saturated: the comparison would be vacuous")
    after = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    timed = _timed_steps(torch, lambda: tr.train_step(state, on_card, draws), rank_device,
                         *PARALLEL_TIMED)
    print(f"parallel (b) the one-process reference, U16/512 bs4 fp32 fma: loss "
          f"{one['loss']:.6f}, grad norm {one['grad_norm']:.6f}; a step {timed['ms']:.3f} ms "
          f"(median of {PARALLEL_TIMED[1]}), peak "
          + (f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB" if cuda else "n/a"))
    one.update(ms=timed["ms"], peak_mib=torch.cuda.max_memory_allocated() / 2**20
               if cuda else None)
    del model, tr, state
    n = int(ola_seconds * FS)
    rng = np.random.default_rng(5)
    tt = np.arange(n) / FS
    ola_mix = (0.3 * np.sin(2 * np.pi * 220 * tt) + 0.2 * np.sin(2 * np.pi * 1330 * tt)
               + 0.05 * rng.standard_normal(n)).astype(np.float32)
    model = models.get_model("relu", **hp, device=device).eval()
    model.load_state_dict(weights)
    ola_ref = OverlapAddSeparator(model, chunk_samples=t, batch_chunks=BATCH,
                                  forward_fn=functools.partial(improved_forward_fast, model)
                                  ).separate(ola_mix)
    del model
    ckpt = os.path.join(tmp, "weights.pt")
    torch.save(weights, ckpt)
    wav = os.path.join(tmp, "long.wav")
    wavfile.write(wav, FS, (ola_mix / np.abs(ola_mix).max() * 0.9 * 32767).astype(np.int16))
    sep_argv = ["--checkpoint", ckpt, "--input", wav, "--mode", "seq_parallel", "-fs", str(FS),
                "--device", rank_device, *hp_argv(hp)]
    U.fused_uconv_block.launches = 0
    run_cli(separate_main, sep_argv + ["--out_dir", os.path.join(tmp, "sep1")])
    one_rank_launches = U.fused_uconv_block.launches
    root = write_wham_corpus(os.path.join(tmp, "wham"), train_cut["n_train"],
                             train_cut["n_val"], train_cut["seconds"], FS, seed=0)
    train_argv = [*_train_argv("relu", hp, root, tmp, "parallel", rank_device),
                  "--n_model", "2", "--n_epochs", "1", "--n_jobs", "1"]
    torch.save(dict(hp=hp, weights=weights, batch=batch, draws=draws, after=after,
                    ola_mix=ola_mix, ola_ref=ola_ref, chunk=t, batch_chunks=BATCH,
                    separate_argv=sep_argv + ["--out_dir", os.path.join(tmp, "sep2")],
                    train_argv=train_argv), os.path.join(tmp, "case.pt"))

    # (b) to (e) on two ranks
    t0 = time.perf_counter()
    mp.start_processes(_parallel_rank, nprocs=2, start_method="spawn", join=True,
                       args=(2, tmp, cuda, _free_port()))
    ranks_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    out["ranks_seconds"] = ranks_s
    print(f"parallel: the two ranks took {ranks_s:.1f} s (spawn and CUDA init included); "
          "seconds by part: " + "; ".join(
              f"rank {r} " + ", ".join(f"{k} {v:.1f}" for k, v in rk["part_seconds"].items())
              for r, rk in enumerate(ranks)))
    out["b"] = {}
    for name, label in (("dp", "DP step, 2 rows a rank"),
                        ("tp", "(data 1, model 2) step, storage + compute TP, fma")):
        rows = [r[name] for r in ranks]
        out["b"][name] = dict(backend=ranks[0]["backend"], one_process=one, ranks=rows)
        for r, row in enumerate(rows):
            share = row["collective_share"]
            print(f"parallel (b) {ranks[0]['backend']} rank {r} of 2 on {rank_device}, {label}: "
                  f"loss {row['loss']:.6f} (one process {one['loss']:.6f}), grad norm "
                  f"{row['grad_norm']:.6f} ({one['grad_norm']:.6f}), params "
                  f"{row['params_db']:.2f} dB, update {row['update_db']:.2f} dB from the "
                  f"one-process step; step {row['ms']:.3f} ms (median of "
                  f"{PARALLEL_TIMED[1]}), collectives "
                  + (f"{share:.2%}" if share is not None else "not in the trace")
                  + f" {row['collective_ms_by_event']}, peak "
                  + (f"{row['peak_mib']:.0f} MiB" if row["peak_mib"] is not None else "n/a")
                  + (f"; sharded {len(row['sharded'])} params" if row["sharded"] else ""))
            if (abs(row["loss"] - one["loss"]) > PARALLEL_LOSS_ABS
                    or abs(row["grad_norm"] - one["grad_norm"]) > PARALLEL_NORM_REL * one[
                        "grad_norm"] or row["params_db"] < PARALLEL_MIN_PARAMS_DB):
                raise RuntimeError(f"(b) {name} rank {r} parts from the one-process step: {row}")
    want = n_forward_batches(n, t, BATCH) * hp["num_blocks"]
    for r, rk in enumerate(ranks):
        o = rk["ola"]
        print(f"parallel (c) DP overlap-add through K1, {ola_seconds:.0f} s mixture, rank {r} "
              f"of 2 ({rk['backend']}, {rank_device}): {o['seconds']:.3f} s, "
              f"{o['k1_launches']} K1 launches (the unsharded separator's batches x blocks: "
              f"{want}), largest difference from the unsharded separator {o['max_abs']:.3e} "
              f"(its peak {o['ref_peak']:.3f})")
        if cuda and o["k1_launches"] != want:
            raise RuntimeError(f"(c) rank {r} launched K1 {o['k1_launches']} times, want {want}")
        if not o["max_abs"] <= 1e-4 * max(1.0, o["ref_peak"]):
            raise RuntimeError(f"(c) rank {r} parts from the unsharded separator: {o}")
    out["c"] = [rk["ola"] for rk in ranks]
    lsb = 0
    for s in (1, 2):
        a = wavfile.read(os.path.join(tmp, "sep1", f"long_s{s}.wav"))[1].astype(np.int32)
        b = wavfile.read(os.path.join(tmp, "sep2", f"long_s{s}.wav"))[1].astype(np.int32)
        if a.shape != b.shape:
            raise RuntimeError(f"(d) shapes {a.shape} and {b.shape}")
        lsb = max(lsb, int(np.abs(a - b).max()))
    out["d"] = dict(backend=ranks[0]["backend"], lsb=lsb, one_rank_k1_launches=one_rank_launches,
                    ranks=[rk["seq_cli"] for rk in ranks])
    print(f"parallel (d) sudo-torch-separate --mode seq_parallel, {ola_seconds:.0f} s wav, over "
          f"2 {ranks[0]['backend']} ranks: "
          + ", ".join(f"rank {r} {rk['seq_cli']['seconds']:.2f} s, "
                      f"{rk['seq_cli']['k1_launches']} K1 launches"
                      for r, rk in enumerate(ranks))
          + f"; the one-rank CLI {one_rank_launches} K1 launches; {lsb} LSB apart")
    if lsb > 1:
        raise RuntimeError(f"(d) the 2-rank seq_parallel CLI is {lsb} LSB from one rank's")
    ck = os.path.join(tmp, "ckpt", "parallel")
    names = sorted(os.listdir(ck))
    last = os.path.join(ck, "relu_epoch_1")
    if "relu_epoch_1" not in names:
        raise RuntimeError(f"(e) no checkpoint relu_epoch_1 in {names}")
    loaded = models.load_checkpoint_model("relu", hp, last, device)
    with torch.no_grad():
        y = improved_forward_fast(loaded, torch.from_numpy(batch[:1, :1]).to(device), impl="fma")
    if not bool(torch.isfinite(y).all()):
        raise RuntimeError("(e) rank 0's checkpoint gives a non-finite forward")
    counts = checkpoint_counts(last)
    out["e"] = dict(backend=ranks[0]["backend"], checkpoints=names, counts=counts,
                    ranks=[rk["train_cli"] for rk in ranks])
    print(f"parallel (e) sudo-torch-train --n_model 2 over 2 {ranks[0]['backend']} ranks, one "
          f"epoch of {train_cut['n_train'] // BATCH} steps: "
          + ", ".join(f"rank {r} {rk['train_cli']['seconds']:.1f} s" for r, rk in enumerate(ranks))
          + f"; rank 0 wrote {names}, step/Adam/schedule counts {counts}; it loads into a "
          f"one-process model (finite forward)")
    out["train_steps_k1"] += sum(rk["train_steps_k1"] for rk in ranks)
    if out["train_steps_k1"] or any(rk["train_cli"]["k1_launches"]
                                    or rk["seq_cli"]["k1_launches"] for rk in ranks):
        raise RuntimeError("the DP or TP training or the n-rank shard body launched K1")
    torch.backends.cudnn.deterministic = deterministic
    return out


# the tools phase: the port's serving and quality scripts (scripts/torch_*.py,
# examples/torch_quickstart.py) called in this process at a cut: the batch
# sweep at two batches, the GroupComm int8 gate search at bs4, the quantized sweep of the two U36 configurations at bs4, the
# roofline timed, the long-form run on 2 minutes of the resident phase's
# AUGMENTED test split from its checkpoint, and the quickstart
TOOLS_BATCHES = (8, 32)
TOOLS_N_HI = 3
TOOLS_LONGFORM_MINUTES = 2.0
# the keys each tool promises on a row (numbers, finite; idle_pct null on the CPU)
TOOL_KEYS = {
    "batch_sweep": ("bs", "ms_batch", "au_s_per_s", "idle_pct", "k1_launches", "fidelity_db"),
    "gc_serving": ("bs", "ms_batch", "au_s_per_s", "idle_pct", "k1_launches", "fidelity_db"),
    "quantized": ("bs", "ms_per_batch", "au_s_per_s", "idle_pct", "k1_launches"),
    "roofline": ("flops_g", "compute_floor_ms", "logical_bytes_gb", "logical_roofline_ms",
                 "least_bytes_ms", "floor_ms", "measured_ms", "recoverable_x_max",
                 "fused_traffic_max_x", "idle_pct", "k1_launches"),
    "longform": ("si_sdr_db", "si_sdri_db", "seconds_per_recording", "audio_sec_per_sec",
                 "k1_launches", "idle_pct"),
}


def _tool(path: str):
    """A script of the repo (``scripts/...`` or ``examples/...``) as a module."""
    import importlib.util

    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)), path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _check_keys(tool: str, rows, cuda: bool) -> None:
    for row in rows:
        for key in TOOL_KEYS[tool]:
            v = row.get(key, "absent")
            if v is None and key == "idle_pct" and not cuda:
                continue
            if not isinstance(v, (int, float)) or not math.isfinite(v):
                raise RuntimeError(f"tools {tool}: {key} = {v!r} in {row}")


def tools_phase(torch, np, tmp: str, resident: dict, device: str = "cuda",
                tiny: bool = False) -> dict:
    """The port's tools, each through its ``main(argv)`` with K1's counts at
    0 before it: the rows' keys present and finite; K1 launched once a block
    a forward on every ``kernel`` row; ``kernel`` rows >= 80 dB from the fp32
    plain or ``fma`` forward; bf16 rows >= 35 dB from fp32; the gated GC int8
    recipe, where one exists, >= 25 dB; every roofline time above its floor.
    ``tiny`` runs the scripts at their toy sizes (a CPU rehearsal)."""
    from sudo_rm_rf_tpu_torch.ops import uconv as U

    cuda = device.startswith("cuda")
    common = ["--device", device] + (["--tiny"] if tiny else [])
    n_hi = ["--n_hi", str(TOOLS_N_HI)]
    out, launches = {}, {}

    def run(name, path, argv):
        U.fused_uconv_block.launches = U.fused_uconv_block.launches_bf16_pyramid = 0
        t0 = time.perf_counter()
        result = _tool(path).main(argv)
        launches[name] = (U.fused_uconv_block.launches,
                          U.fused_uconv_block.launches_bf16_pyramid)
        print(f"tools {name}: {time.perf_counter() - t0:.1f} s, K1 launches "
              f"{launches[name][0]} (bf16 pyramid {launches[name][1]})", flush=True)
        return result

    def need(ok, what):
        if not ok:
            raise RuntimeError(f"tools: {what}")

    blocks = 2 if tiny else FLAGSHIP["num_blocks"]
    k1_per_forward = blocks if cuda else 0

    # the batch sweep over its six paths
    rows = run("batch_sweep", "scripts/torch_bench_batch_sweep.py",
               common + n_hi + ["--bs", *map(str, TOOLS_BATCHES)])
    _check_keys("batch_sweep", rows, cuda)
    need(len(rows) == 6 * len(TOOLS_BATCHES), f"batch sweep rows {len(rows)}")
    for r in rows:
        if r["path"].startswith("kernel"):
            need(r["k1_launches"] == k1_per_forward, f"batch sweep {r}")
        if r["path"] == "fma_fp32":
            need(r["fidelity_db"] >= MIN_FIDELITY_DB, f"fma against kernel {r}")
        if r["path"] in ("bf16_conv", "fma_bf16", "kernel_bf16_pyramid"):
            need(r["fidelity_db"] >= BF16_GATE_DB, f"bf16 against fp32 {r}")
    out["batch_sweep"] = rows

    # the GroupComm int8 gate search and its gated recipe's rows
    gated = run("gc_families", "scripts/torch_bench_gc_serving.py",
                common + n_hi + ["--bs", str(BATCH), "--families_sweep"])
    _check_keys("gc_serving", gated, cuda)
    need(all(r["gated_fidelity_db"] >= INT8_GATE_DB and r["k1_launches"] == 0
             for r in gated), f"gated {gated}")
    out["gc_gated"] = gated

    # the quantized sweep at both U36 configurations
    out["quantized"] = {}
    for config in ("u36_2048", "u36_wide"):
        extra = ["--attribute"] if config == "u36_wide" else []
        rows = run(f"quantized_{config}", "scripts/torch_bench_quantized.py",
                   common + n_hi + ["--config", config, "--bs", str(BATCH)] + extra)
        _check_keys("quantized", rows, cuda)
        need(len(rows) == 5, f"quantized {config} rows {len(rows)}")
        depth = 3 if tiny else 36
        for r in rows:
            if r["path"] == "fp32_kernel":
                need(r["k1_launches"] == (depth if cuda else 0), f"quantized {r}")
                need(r["fidelity_db_vs_fp32"] >= MIN_FIDELITY_DB, f"kernel vs fma {r}")
            if r["path"] == "bf16_conv":
                need(r["fidelity_db_vs_fp32"] >= BF16_GATE_DB, f"bf16 vs fp32 {r}")
        out["quantized"][config] = rows

    # the roofline, timed
    rows = run("roofline", "scripts/torch_roofline_bound.py",
               (["--tiny"] if tiny else []) + ["--device", device, "--measure"] + n_hi)
    _check_keys("roofline", rows, cuda)
    for r in rows:
        if r["row"] == "bs4_fp32_kernel":
            need(r["k1_launches"] == k1_per_forward, f"roofline {r}")
        need(not cuda or r["measured_ms"] >= r["floor_ms"], f"below its floor: {r}")
    out["roofline"] = rows

    # the long-form run from the resident phase's AUGMENTED checkpoint
    aug = resident["augmented"]
    lf_hp = [a for k, v in aug["hp"].items() if k != "group_size" for a in (f"--{k}", str(v))]
    summary = run("longform", "scripts/torch_longform_run.py",
                  ["--checkpoint", aug["checkpoint"], "--corpus", aug["test_corpus"],
                   "--minutes", str(TOOLS_LONGFORM_MINUTES), "--reps", "1", "--device", device,
                   "--out", os.path.join(tmp, "longform")] + lf_hp)
    engines = summary["engines"]
    _check_keys("longform", engines.values(), cuda)
    n = int(TOOLS_LONGFORM_MINUTES * 60 * FS)
    chunk = int(CHUNK_SECONDS * FS)
    lf_blocks = aug["hp"]["num_blocks"]
    want = dict(overlap_add=0, overlap_add_kernel=n_forward_batches(n, chunk, 8) * lf_blocks,
                seq_parallel=lf_blocks) if cuda else dict.fromkeys(engines, 0)
    for name, r in engines.items():
        need(r["k1_launches"] == want[name], f"longform {name} {r}, want {want[name]}")
    need(not cuda or engines["seq_parallel"]["route"] == "kernel", f"route {engines}")
    out["longform"] = summary

    # the quickstart
    quick = run("quickstart", "examples/torch_quickstart.py", ["--device", device])
    need(np.isfinite(quick["losses"]).all() and quick["losses"][-1] < quick["losses"][0]
         and np.isfinite(quick["long_mixture_si_sdr_db"]), f"quickstart {quick}")
    out["quickstart"] = quick
    out["launches"] = launches
    return out


PHASES = ("k1", "tac", "k1_bf16", "float64", "serve", "train", "evaluate", "recipes", "augmented",
          "bf16", "int8", "bench", "causal", "zoo", "zoo_cli", "baselines", "musdb",
          "longform", "parallel", "resident", "tools")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=PHASES, default=list(PHASES),
                    help="run these phases only (a rehearsal: no kernels or ok line); "
                         "tools needs resident (its checkpoint and corpus)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the longform phase's 10-minute mixture")
    args = ap.parse_args(argv)
    if "tools" in args.only and "resident" not in args.only:
        ap.error("--only tools needs resident too: it serves the resident phase's checkpoint")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import numpy as np

    from sudo_rm_rf_tpu_torch.data.synthetic import write_wham_corpus
    from sudo_rm_rf_tpu_torch.ops import _build
    from sudo_rm_rf_tpu_torch.ops import uconv as U

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    _build.load_kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {_build.library_path().name}")
    log = _build.library_path().with_name(_build.library_path().name + ".log")
    if log.exists():  # registers, shared memory and spills of each kernel
        name = None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function .*?(4wide\d+)?([a-z_]+_kernel)((?:L[a-z]\d+E|I)*)",
                          line)
            if m:  # template arguments, as in gemm_kernel<2,1,1>; wide:: for the wide route
                args_ = re.findall(r"L[a-z](\d+)E", m.group(3))
                name = (("wide::" if m.group(1) else "") + m.group(2)
                        + (f"<{','.join(args_)}>" if args_ else ""))
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")
    hmma = tensor_core_instructions(_build.library_path())
    if hmma is None:
        print("tensor-core instructions in gemm_kernel SASS: not available (no cuobjdump)")
    else:
        print(f"tensor-core instructions (HGMMA/HMMA) in gemm_kernel SASS: {hmma}")
        if hmma == 0:
            raise RuntimeError("the GEMM kernels hold no tensor-core instruction")

    res, seconds = {}, {}

    def phase(name, fn):
        if name not in args.only:
            return
        t0 = time.perf_counter()
        res[name] = fn()
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]:.1f} s", flush=True)

    # 3. the kernel against its plain version; its bf16 pyramid; float64
    phase("k1", lambda: dict(k1_phase(torch, U, _build.load_kernels(), hmma),
                             wide=k1_wide_check(torch, U),
                             routes=k1_gemm_routes(torch, U, _build.load_kernels()),
                             ladder=k1_ladder_check(torch, U, _build.load_kernels())))
    phase("tac", lambda: tac_check(torch, _build.load_kernels()))
    phase("k1_bf16", lambda: k1_bf16_phase(torch, U))
    phase("float64", lambda: k1_float64_phase(torch, U))

    # 4. and 5. the serving paths through the CLI
    def serve():
        with tempfile.TemporaryDirectory() as tmp:
            out = {"relu": serve_phase(torch, np, tmp, "relu", FLAGSHIP),
                   "groupcomm_v2": serve_phase(torch, np, tmp, "groupcomm_v2", GROUPCOMM,
                                               ["--mixture_consistency", "uniform"])}
        print(json.dumps({"serve": out}))
        return out

    phase("serve", serve)

    # 6. and 7. the training paths
    def train():
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            root = write_wham_corpus(os.path.join(tmp, "wham"), TRAIN_FILES, VAL_FILES,
                                     CHUNK_SECONDS, FS, seed=0)
            print(f"train: corpus of {TRAIN_FILES} + {VAL_FILES} wavs of {CHUNK_SECONDS} s "
                  f"in {time.perf_counter() - t0:.1f} s")
            out = {"train": train_phase(torch, np, tmp, root, FLAGSHIP),
                   "train_gc": gc_train_phase(torch, np, tmp, root, GROUPCOMM)}
        print(json.dumps(out))
        return out

    phase("train", train)

    # 8. evaluation of U36/Bases4096 at 16 kHz
    def evaluate():
        with tempfile.TemporaryDirectory() as tmp:
            out = eval_phase(torch, np, tmp, U36)
        print(json.dumps({"evaluate": out}))
        return out

    phase("evaluate", evaluate)

    # 9. the WHAMR and FUSS recipes
    def recipes():
        with tempfile.TemporaryDirectory() as tmp:
            out = {name: recipe_train_phase(torch, np, tmp, name, run)
                   for name, run in RECIPE_RUNS.items()}
        print(json.dumps({"train_recipes": out}))
        return out

    phase("recipes", recipes)

    # 13. the AUGMENTED train -> msgpack checkpoint -> evaluate -> export loop
    def augmented():
        with tempfile.TemporaryDirectory() as tmp:
            out = augmented_phase(torch, np, tmp, FLAGSHIP)
        print(json.dumps({"augmented": out}))
        return out

    phase("augmented", augmented)

    # 10. reduced-precision serving: bf16 and int8; 11. the bench
    def bf16():
        out = {"relu": bf16_serve_phase(torch, np, "relu", FLAGSHIP),
               "groupcomm_v2": bf16_serve_phase(torch, np, "groupcomm_v2", GROUPCOMM)}
        print(json.dumps({"serve_bf16": out}))
        return out

    def int8():
        out = {"relu": int8_phase(torch, np, "relu", FLAGSHIP),
               "groupcomm_v2": int8_phase(torch, np, "groupcomm_v2", GROUPCOMM)}
        print(json.dumps({"serve_int8": out}))
        return out

    def bench():
        out = bench_phase(torch)
        print(json.dumps({"bench": out}))
        return out

    phase("bf16", bf16)
    phase("int8", int8)
    phase("bench", bench)

    # 15.-17. the rest of the family: causal and streaming, v1 and the
    # attentive models with remat_blocks, and their CLI
    def causal():
        out = causal_phase(torch, np)
        print(json.dumps({"causal": out}))
        return out

    def zoo():
        out = zoo_phase(torch, np)
        print(json.dumps({"zoo": out}))
        return out

    def zoo_cli():
        with tempfile.TemporaryDirectory() as tmp:
            out = zoo_cli_phase(torch, np, tmp)
        print(json.dumps({"zoo_cli": out}))
        return out

    # 17. the baselines, radam_cosine and their bench rows
    def baselines():
        with tempfile.TemporaryDirectory() as tmp:
            out = baselines_phase(torch, np, tmp)
        print(json.dumps({"baselines": out}))
        return out

    phase("causal", causal)
    phase("zoo", zoo)
    phase("zoo_cli", zoo_cli)
    phase("baselines", baselines)

    # 18. MUSDB: train, bf16 uploads, shards, separate the 4-stem checkpoint
    def musdb():
        with tempfile.TemporaryDirectory() as tmp:
            out = musdb_phase(torch, np, tmp)
        print(json.dumps({"musdb": out}))
        return out

    phase("musdb", musdb)

    # 19. exact long-form separation of a 10-minute recording
    def longform():
        with tempfile.TemporaryDirectory() as tmp:
            out = longform_phase(torch, np, tmp, seed=args.seed)
        print(json.dumps({"longform": out}))
        return out

    phase("longform", longform)

    # 20. data and tensor parallelism over torch.distributed ranks
    def parallel():
        with tempfile.TemporaryDirectory() as tmp:
            out = parallel_phase(torch, np, tmp)
        print(json.dumps({"parallel": out}))
        return out

    phase("parallel", parallel)

    # 21. the published recipes as written: device-resident data, chained
    # steps, the in-flight bound, block_impl auto and the native reader
    # its directory (checkpoint and corpus) lives on for the tools phase
    resident_dir = tempfile.TemporaryDirectory()

    def resident():
        out = resident_phase(torch, np, resident_dir.name)
        print(json.dumps({"resident": out}))
        return out

    phase("resident", resident)

    # 22. the port's serving and quality tools
    def tools():
        with tempfile.TemporaryDirectory() as tmp:
            out = tools_phase(torch, np, tmp, res["resident"])
        print(json.dumps({"tools": out}))
        return out

    phase("tools", tools)
    resident_dir.cleanup()
    print(f"phase seconds: {json.dumps(seconds)}")
    if set(args.only) != set(PHASES):
        print(f"chip_smoke: ran {args.only} only; no kernels line and no ok line")
        return 0

    serve, k1 = res["serve"], res["k1"]
    train, train_gc = res["train"]["train"], res["train"]["train_gc"]
    evaluation, recipes = res["evaluate"], res["recipes"]
    flagship, pyr = k1["flagship"], res["k1_bf16"]
    bench_runs = res["bench"]
    print(json.dumps({"kernels": [{
        "name": "fused_uconv_block", "route": "cuda",
        "source": "sudo_rm_rf_tpu_torch/csrc/uconv.cu",
        "replaces": "sudo_rm_rf_tpu/ops/pallas/uconv.py:370",
        "launches": serve["relu"]["launches"],
        "launches_per_forward": serve["relu"]["launches_per_forward"],
        "launches_gc": serve["groupcomm_v2"]["launches"],
        "launches_per_gc_forward": serve["groupcomm_v2"]["launches_per_forward"],
        "launches_training_path": train["train_launches"],
        "launches_gc_training_path": train_gc["train_launches"],
        "launches_eval_path": evaluation["crops"]["launches"],
        "launches_eval_full_length": evaluation["full_length"]["launches"],
        "launches_per_u36_forward": evaluation["launches_per_forward"],
        **{f"launches_{name.lower()}_training_path": r["train_launches"]
           for name, r in recipes.items()},
        "launches_bf16_serving": res["bf16"]["relu"]["kernel"]["k1_launches"],
        "launches_bench_fp32": bench_runs["fp32"]["k1_launches"],
        "launches_augmented_eval": res["augmented"]["eval_launches"],
        "launches_augmented_separate": res["augmented"]["separate_launches"]["msgpack"],
        # the causal, v1 and attentive paths hold no U-ConvBlock of K1's kind
        "launches_causal_path": res["causal"]["k1_launches"],
        "launches_zoo_paths": sum(r["k1_launches"] for k, r in res["zoo"].items()
                                  if k != "remat"),
        "launches_zoo_cli": sum(r["k1_launches"] for r in res["zoo_cli"].values()),
        # nor do the baselines, their bench rows or the radam_cosine CLI run
        "launches_baseline_paths": sum(r["k1_launches"] for r in res["baselines"].values()),
        # MUSDB trains through the xla blocks and serves its 4 stems through K1
        "launches_musdb_training_path": res["musdb"]["train"]["k1_launches"],
        "launches_musdb_separate": res["musdb"]["separate"]["launches"],
        # one 10-minute pass through the one-rank K1 route (the n-shard body
        # runs plain ops: 0), and K1 at that pass's block shape
        "launches_longform_u16": res["longform"]["families"]["relu"]["runs"]["kernel"][
            "k1_launches"],
        "launches_longform_gc": res["longform"]["families"]["groupcomm_v2"]["runs"]["kernel"][
            "k1_launches"],
        "launches_longform_bf16": sum(
            f["runs"]["kernel_bf16"]["k1_launches"] for f in res["longform"]["families"].values()),
        "launches_longform_shard_body": sum(
            r["k1_launches"] for f in res["longform"]["families"].values()
            for k, r in f["runs"].items() if not k.startswith("kernel")),
        "launches_longform_cli": res["longform"]["cli"]["k1_launches"],
        # DP overlap-add over two ranks runs its chunks through K1 on each
        # rank; the DP and TP train steps, the n-rank shard body and the TP
        # training CLI launch none
        "launches_parallel_dp_overlap_add_per_rank": [
            r["k1_launches"] for r in res["parallel"]["c"]],
        "launches_parallel_train_steps": res["parallel"]["train_steps_k1"],
        "launches_parallel_shard_body": sum(
            r["k1_launches"] for r in res["parallel"]["d"]["ranks"]),
        "launches_parallel_train_cli": sum(
            r["k1_launches"] for r in res["parallel"]["e"]["ranks"]),
        # the MUSDB recipe as written trains with no K1 (resident, chained
        # and single-step epochs, and the AUGMENTED resident epoch) and
        # separates its checkpoint through K1, 16 a bs8 batch
        "launches_resident_training_paths": sum(
            r["k1_launches"] for r in (res["resident"]["musdb"], res["resident"]["augmented"],
                                       *res["resident"]["host"].values())),
        "launches_resident_separate": res["resident"]["musdb"]["separate"]["launches"],
        "longform_shape": res["longform"]["k1_long"],
        # the tools phase: each tool's K1 launches over its run (the batch
        # sweep's two batches, the quantized sweep's U36 and wide forwards at
        # 36 a forward, the roofline's timed kernel row, the long-form run's
        # kernel engines; the GC gate search and the quickstart 0)
        **{f"launches_tools_{name}": n for name, (n, _) in res["tools"]["launches"].items()},
        **flagship, "gc_shape": k1["groupcomm"], "u36_shape": k1["u36"],
        "wide_shape": {b: r for b, r in k1["wide"].items() if r["pyramid"] == "fp32"},
        "ladder_shapes": {n: r for n, r in k1["ladder"].items() if r["pyramid"] == "fp32"},
        "float64_check": res["float64"],
    }, {
        "name": "fused_uconv_block(pyramid_dtype=bfloat16)", "route": "cuda",
        "source": "sudo_rm_rf_tpu_torch/csrc/uconv.cu",
        "replaces": "sudo_rm_rf_tpu/ops/pallas/uconv.py:370 (pyramid_dtype, :368)",
        "launches": res["bf16"]["relu"]["kernel_bf16_pyramid"]["k1_bf16_pyramid_launches"],
        "launches_gc_bf16_serving": res["bf16"]["groupcomm_v2"]["kernel_bf16_pyramid"][
            "k1_bf16_pyramid_launches"],
        "launches_tools_batch_sweep": res["tools"]["launches"]["batch_sweep"][1],
        **pyr["flagship"], "gc_shape": pyr["groupcomm"], "u36_shape": pyr["u36"],
        "wide_shape": {b: r for b, r in k1["wide"].items() if r["pyramid"] == "bf16"},
        "ladder_shapes": {n: r for n, r in k1["ladder"].items() if r["pyramid"] == "bf16"},
    }, {
        "name": "fused_tac", "route": "cuda", "source": "sudo_rm_rf_tpu_torch/csrc/tac.cu",
        "replaces": None,  # the JAX package runs TAC in plain XLA
        "launches_gc_cli": serve["groupcomm_v2"]["tac_launches"],
        "launches_relu_cli": serve["relu"]["tac_launches"],
        "shapes": res["tac"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
