"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

1. Print the card (``nvidia-smi`` name and power limit) and the torch build;
   fail without CUDA. TF32 is off, so fp32 is compared with fp32.
2. Build the CUDA kernels from ``sudo_rm_rf_tpu_torch/csrc``; print each
   kernel's registers and spills, and the count of tensor-core instructions
   (``HGMMA``/``HMMA``) in the GEMM kernels' SASS where ``cuobjdump`` exists
   (failing if it is 0).
3. The U-ConvBlock kernel (K1) against its plain version at the flagship
   block shape (Co=256, Ci=512, T=3200, depth 5; B=1, 4, 8) and at two ragged
   ones, within rtol=atol=1e-4; two calls on one input must be bit-identical.
   At the flagship shape, time the kernel, ``uconv_block_fma`` and
   ``uconv_block_reference`` (CUDA events, median of 25 after warm-up). At
   B=4: the device time of each of K1's parts (``torch.profiler``), K1's
   bound, and the ``torch.matmul`` time of the same two products (TF32 off,
   and labelled, on), a yardstick the port never calls.
4. The serving path: ``sudo-torch-separate`` with a seeded random Improved
   SuDoRM-RF U16/512 checkpoint on three synthetic 8 kHz wavs (3 s, 10 s,
   25 s), batch 4. Checks the outputs, that the kernel ran 16 times per
   forward batch, and one file against a separation through the plain
   blocks. Then kernel-vs-plain fidelity of one 4 s bs4 forward (>= 80 dB),
   the bs4 fp32 forward time of each block form, and the kernel forward's
   device time by kernel with the device's idle share.
5. Print a JSON line of kernel results, then ``{"ok": true, "device": ...}``
   as the last line. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import functools
import json
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
# B, Co, Ci, T, depth: the flagship block at batch 1, 4 and 8; a ragged one;
# and one with T % 4 != 0, which takes the kernel's 4-byte load paths
BLOCK_SHAPES = [(1, 256, 512, 3200, 5), (4, 256, 512, 3200, 5),
                (8, 256, 512, 3200, 5), (2, 20, 36, 648, 4), (2, 70, 100, 334, 2)]
WAV_SECONDS = (3.0, 10.0, 25.0)
MIN_FIDELITY_DB = 80.0
# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
K1_PARTS = ("split", "gemm", "ladder", "fold", "upsum")


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


def k1_bound(b, co, ci, t, depth) -> dict:
    """Least time (ms) the card could take for one K1 call: the larger of its
    bytes (x in, out, the params, each once) over the memory rate and its
    operations over the peak of their type. The two GEMMs do 2 * B * Ci * Co
    * T flops each; K1 takes them in 3xTF32, three TF32 passes on the tensor
    cores, and ``bound_fp32_simt_ms`` is the same work on the fp32 pipes. The
    ladder (5 multiply-adds, the fold and PReLU: ~12 flops an output) and the
    upsample-sum (one multiply-add a level) are fp32."""
    gemm = 2 * 2 * b * ci * co * t
    other = b * ci * (12 * sum(t >> k for k in range(depth)) + 2 * depth * t)
    params = 2 * ci * co + ci * (8 * depth + 5) + co
    mem = 4 * (2 * b * co * t + params) / PEAK_BYTES
    ops = 3 * gemm / PEAK_TF32 + other / PEAK_FP32
    return dict(bound_ms=1e3 * max(ops, mem), bound_by="operations" if ops >= mem else "bytes",
                bound_fp32_simt_ms=1e3 * max((gemm + other) / PEAK_FP32, mem))


def device_ms_by_kernel(torch, fn, calls: int) -> dict:
    """Device time per call of fn, summed by K1 part (``<part>_kernel``) and
    "other", from ``torch.profiler``; empty if the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            m = re.search(r"(%s)_kernel" % "|".join(K1_PARTS), e.key)
            name = m.group(1) if m else "other"
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import numpy as np
    from scipy.io import wavfile

    from sudo_rm_rf_tpu_torch import models
    from sudo_rm_rf_tpu_torch.cli.separate import main as separate_main
    from sudo_rm_rf_tpu_torch.data.base import read_wav
    from sudo_rm_rf_tpu_torch.inference import separate_file
    from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast
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
            m = re.search(r"Compiling entry function .*?([a-z]+_kernel)((?:L[a-z]\d+E|I)*)", line)
            if m:  # template arguments, as in gemm_kernel<2,1,1>
                args = re.findall(r"L[a-z](\d+)E", m.group(2))
                name = m.group(1) + (f"<{','.join(args)}>" if args else "")
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")
    hmma = tensor_core_instructions(_build.library_path())
    if hmma is None:
        print("tensor-core instructions in gemm_kernel SASS: not available (no cuobjdump)")
    else:
        print(f"tensor-core instructions (HGMMA/HMMA) in gemm_kernel SASS: {hmma}")
        if hmma == 0:
            raise RuntimeError("the GEMM kernels hold no tensor-core instruction")

    # 3. the kernel against its plain version
    kernel_row = {}
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
        if (co, ci, t, depth) == (256, 512, 3200, 5):
            ms = {name: time_ms(torch, lambda f=f: f(x, p, depth)) for name, f in (
                ("kernel", U.fused_uconv_block), ("fma", U.uconv_block_fma),
                ("plain", U.uconv_block_reference))}
            print(f"K1 flagship B={b} ms (median of 25): kernel {ms['kernel']:.4f} "
                  f"fma {ms['fma']:.4f} plain {ms['plain']:.4f}")
            if b == BATCH:  # the serving path's shape
                kernel_row = dict(max_abs_err=err, ms=ms["kernel"], plain_ms=ms["plain"],
                                  **k1_bound(b, co, ci, t, depth))
                parts = device_ms_by_kernel(torch, lambda: U.fused_uconv_block(x, p, depth), 20)
                print("K1 B=4 device ms per call by part (torch.profiler, 20 calls): "
                      + (", ".join(f"{k} {parts[k]:.4f}" for k in K1_PARTS if k in parts)
                         or "not measured (no device time in the trace)"))
                acc_in = torch.randn(b, ci, t, generator=torch.Generator().manual_seed(2)).cuda()
                two = lambda: (torch.matmul(p["proj_w"], x), torch.matmul(p["res_w"], acc_in))
                lib_ms = time_ms(torch, two)
                torch.backends.cuda.matmul.allow_tf32 = True
                lib_tf32_ms = time_ms(torch, two)
                torch.backends.cuda.matmul.allow_tf32 = False
                print(f"K1 B=4 yardstick, torch.matmul of the same two products: fp32 "
                      f"{lib_ms:.4f} ms, TF32 (one pass, ~3 digits) {lib_tf32_ms:.4f} ms")
                print(f"K1 B=4 bound {kernel_row['bound_ms']:.4f} ms (3xTF32 tensor cores, "
                      f"{kernel_row['bound_by']}; share {kernel_row['bound_ms'] / ms['kernel']:.1%}), "
                      f"{kernel_row['bound_fp32_simt_ms']:.4f} ms on the fp32 pipes (share "
                      f"{kernel_row['bound_fp32_simt_ms'] / ms['kernel']:.1%})")
                kernel_row.update(library_ms=lib_ms, library_tf32_ms=lib_tf32_ms,
                                  library_call="torch.matmul of the proj and res products",
                                  parts_ms={k: parts.get(k) for k in K1_PARTS},
                                  bit_identical=True, tensor_core_instructions=hmma)

    # 4. the serving path through the CLI
    chunk = int(CHUNK_SECONDS * FS)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        model = models.get_model("relu", **FLAGSHIP, device="cuda",
                                 generator=torch.Generator().manual_seed(0))
        model.eval()
        ckpt = os.path.join(tmp, "u16_512.pt")
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
        out_dir = os.path.join(tmp, "separated")
        argv = ["--checkpoint", ckpt, "--model_type", "relu", "--input",
                *(w for w, _ in wavs), "--out_dir", out_dir, "--device", "cuda",
                "--batch_chunks", str(BATCH), "-fs", str(FS),
                "--chunk_seconds", str(CHUNK_SECONDS)]
        for key in ("out_channels", "in_channels", "num_blocks",
                    "upsampling_depth", "enc_kernel_size", "enc_num_basis"):
            argv += [f"--{key}", str(FLAGSHIP[key])]
        U.fused_uconv_block.launches = 0
        t0 = time.perf_counter()
        if separate_main(argv) != 0:
            raise RuntimeError("sudo-torch-separate returned non-zero")
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = U.fused_uconv_block.launches
        print(f"CLI: {len(wavs)} files, {batches} forward batches, "
              f"{launches} kernel launches, {cli_s:.2f} s")
        if launches != FLAGSHIP["num_blocks"] * batches:
            raise RuntimeError(f"expected {FLAGSHIP['num_blocks'] * batches} "
                               f"kernel launches, counted {launches}")
        for path, n in wavs:
            stem = os.path.splitext(os.path.basename(path))[0]
            for s in (1, 2):
                sr, est = read_wav(os.path.join(out_dir, f"{stem}_s{s}.wav"))
                if sr != FS or est.shape != (n,) or not np.isfinite(est).all():
                    raise RuntimeError(f"{stem}_s{s}: sr {sr} shape {est.shape}")
                if not np.abs(est).max() > 0:
                    raise RuntimeError(f"{stem}_s{s} is silent")
        # one file again, through the plain blocks: the int16 outputs agree
        plain_dir = os.path.join(tmp, "plain")
        separate_file(model, wavs[1][0], plain_dir, fs=FS,
                      chunk_seconds=CHUNK_SECONDS, batch_chunks=BATCH,
                      forward_fn=functools.partial(improved_forward_fast, model, impl="xla"))
        stem = os.path.splitext(os.path.basename(wavs[1][0]))[0]
        for s in (1, 2):
            a = wavfile.read(os.path.join(out_dir, f"{stem}_s{s}.wav"))[1].astype(np.int32)
            c = wavfile.read(os.path.join(plain_dir, f"{stem}_s{s}.wav"))[1].astype(np.int32)
            lsb = int(np.abs(a - c).max())
            print(f"CLI {stem}_s{s}: kernel vs plain blocks max diff {lsb} LSB")
            if lsb > 1:
                raise RuntimeError(f"{stem}_s{s}: kernel and plain outputs differ by {lsb} LSB")

        # fidelity and speed of one bs4 4 s forward
        x = torch.from_numpy(rng.standard_normal((BATCH, 1, chunk)).astype(np.float32)).cuda()
        ker = improved_forward_fast(model, x, impl="kernel")
        ref = improved_forward_fast(model, x, impl="xla")
        if ker.shape != (BATCH, 2, chunk) or not torch.isfinite(ker).all():
            raise RuntimeError(f"bad forward output {tuple(ker.shape)}")
        fid = fidelity_db(np, ref.double().cpu().numpy(), ker.double().cpu().numpy())
        print(f"U16/512 bs{BATCH} fp32 forward fidelity kernel vs xla: {fid:.2f} dB")
        if not fid >= MIN_FIDELITY_DB:
            raise RuntimeError(f"fidelity {fid:.2f} dB < {MIN_FIDELITY_DB} dB")
        audio_s = BATCH * CHUNK_SECONDS
        fwd_ms = {}
        for impl in ("kernel", "fma", "xla"):
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(torch, lambda i=impl: improved_forward_fast(model, x, impl=i), reps=20)
            fwd_ms[impl] = ms
            peak = torch.cuda.max_memory_allocated() / 2**20
            print(f"U16/512 bs{BATCH} fp32 forward impl={impl}: {ms:.3f} ms, "
                  f"{audio_s / (ms / 1e3):.1f} audio-s/s, peak {peak:.0f} MiB")
        by_kernel = device_ms_by_kernel(
            torch, lambda: improved_forward_fast(model, x, impl="kernel"), 5)
        busy = sum(by_kernel.values())
        print(f"U16/512 bs{BATCH} kernel forward device ms by kernel (torch.profiler, 5 "
              f"forwards): " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(by_kernel.items()))
              + f"; busy {busy:.3f} of {fwd_ms['kernel']:.3f} ms, idle "
              f"{1 - busy / fwd_ms['kernel']:.1%}")

    print(json.dumps({"kernels": [{
        "name": "fused_uconv_block", "route": "cuda",
        "source": "sudo_rm_rf_tpu_torch/csrc/uconv.cu",
        "replaces": "sudo_rm_rf_tpu/ops/pallas/uconv.py:370",
        "launches": launches, "launches_per_forward": FLAGSHIP["num_blocks"], **kernel_row,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
