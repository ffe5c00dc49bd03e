#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its elapsed seconds):
  0. the card's name and power limit; TF32 off;
  1. build the CUDA kernels from ``image_enhance_keras_tpu_torch/csrc``
     (one nvcc per source, all started together); the int8 kernels' SASS
     must hold wgmma (GMMA) and no dp4a (IDP), in all 23 kernel functions
     of ``int8_blocks.cu`` (K4/K5's 17, X3's 6) but the three
     abs-max passes and the dynamic forms' two requantization passes
     (K4/K5's, X3's), and in the 21 conv functions of ``int8_conv.cu`` (X4's
     15, X1's, X2's and X1u's 6 ``xla_block_kernel`` forms),
     the block and chain kernels'
     SASS wgmma (their 3xTF32 products), in every kernel function, the bf16
     forms' included;
  2. each kernel at the main paths' shapes against its plain PyTorch
     version, with its time, the plain version's, a library call's where
     one computes the same function, and the card's bound:
       float32 (9 tiles of 96x96x128, demo weights, inputs from the pallas
       path itself): the Light53 and Light blocks (K1, K2), and the Light53
       and Light chains over the 16 / 6 stacked blocks (K6, K7), each also
       against the per-block kernels; all four also on ragged crops of
       their inputs (1x57x86, 1x86x57, 1x57x57, 1x5x70, 1x8x64); every
       float32 row with two bounds, the CUDA cores' float32 FMA and the
       TF32 tensor cores' 3xTF32, and the lesser as its bound;
       bf16 (``--dtype bfloat16``, inputs from the bf16 path itself): K1
       and K2 at (9,96,96,128) and on the ragged crops, and K6 and K7 with
       one block there, each against its plain bf16 version (the share of
       elements that differ and the largest gap in bf16 ulps); the full 16-
       and 6-block chains against a yardstick, the gap between the plain
       chain summed in float64 and in float32; the library is cuDNN's bf16
       ``F.conv2d`` of the same convs, which rounds at other points;
       int8 path (the demo weights quantized by the port's calibration,
       bf16 inputs from the int8 path itself): the int8 Light53 block at
       (9,96,96,128) and at the tail's (9,384,384,128) (K4), the int8 Light
       block (K5), and the TF1 x4 upsample in bf16 and float32 (K3), each
       bit-equal to its plain version (K3 with its bytes/s and share of
       the byte bound per call and in device time);
       K4 and K5 also on ragged crops of
       the path's input (1x57x86, 1x70x70, 1x86x57, 1x5x70, 1x8x64: widths
       above and below one 64-column tile); one yardstick line, cuDNN's
       bf16 ``F.conv2d`` of the four Light53 convs at the tail's shape;
       K4/K5's dynamic forms (``act_scales=None``, per-window scales) on
       the uncalibrated path's own inputs, K4 at LR and HR, K5 at LR, and
       on the ragged crops, and K4/K5 on float32 x, static and dynamic,
       each bit-equal to its plain version, with the SASS GMMA lines of
       its kernel functions and the device ms of each of its launches;
       the ``--forward int8`` forms (the int8 forward's own activations: the
       level1 output, the 16 plain X1 blocks' output, their x4 at
       (9,384,384,128)): X1 at LR and HR, X2 at LR, X3 at HR, bit-equal to
       their plain versions under the bf16 and s32 accumulators and on the
       ragged crops, with times, device ms per launch, GMMA lines, the bound
       and ``torch._int_mm`` over an int8 im2col of the same convs;
  3. the main paths through ``cli.main_dirpath`` on a seeded 128x128 BMP
     (9 tiles at 96/64/8, 512x512 out), each with its kernel launches
     counted: ``--forward pallas`` (K1, K2), ``--forward xla`` as its
     reference, ``--forward pallas_chain`` (K6, K7), the same two with
     ``--dtype bfloat16`` (bf16 K1, K2; bf16 K6, K7; K3 never), each also
     with the plain bf16 versions in place of the kernels as its reference,
     ``--forward pallas_int8`` (K3, K4, K5; calibration included), and the
     int8 run again with the plain x4 in place of K3 and with the plain
     int8 blocks in place of K4 and K5 (each byte-equal); 3e: ``--forward
     int8`` (X1 18, X2 6, K3 twice), byte-equal with the plain x4 and the
     plain X blocks, ``--int8-emit s8`` byte-equal with wide, ``--int8-acc
     s32`` with its plain blocks; 3a'': the
     uncalibrated ``apply_didbl_int8`` (a tree quantized without
     ``calib_x``) at full width on the 9 patches: K4 18, K5 6, K3 1,
     bit-equal to the plain dynamic blocks, PSNR against float32, its time
     beside the calibrated tree's, a profile, and bit-equality on a whole
     86x57 Set5 frame; 3a''': ``--dtype mixed`` and ``mixed-tail`` on
     ``xla`` (one float32 / one bf16 K3, each byte-equal with the plain x4),
     ``--forward pallas`` and ``pallas_chain`` with ``--dtype mixed``
     (byte-equal with their bf16 runs, bf16 K1/K2 and K6/K7 counted),
     ``--forward pallas_int8 --dtype bfloat16`` (byte-equal with float32),
     and both mixed profiles on a crop against the CPU; 3c: a seeded
     512x512 image in fast mode, split mode (stripes of 64 body rows) and
     split mode on 2-D tiles (128/128: 16 tiles, two chunks of 8) on
     ``xla`` float32, ``xla`` bf16, ``pallas_int8`` and ``--forward int8
     --dtype bfloat16`` (the serving profile), each split run against fast
     (int8: byte-equal) and byte-equal with the plain x4 (and the plain int8
     blocks), K3 / K4 / K5 / X1 / X2 counted per stripe and chunk,
     out-Mpix/s and peak device memory per run; then the int8 forward with
     ``int8_dynamic_tail`` (X3 twice) and ``int8_body_tile=256``, each
     byte-equal with its plain blocks, the tiled body with the untiled
     forward; 3d: the x8 self-ensemble with 2
     back-projection steps on a 48x48 crop against the CPU; then the engines
     (the bf16 and int8 ones too) timed in turns, the bf16 and int8 forwards
     profiled (device time by kernel, idle share), and CPU references on a
     crop;
  4. Set5 x4 (``data_set5``, read by the numpy PNG decoder where PIL is
     missing): ``scorpath --generate`` with ``--forward xla`` and
     ``pallas_chain`` (launches counted), the bicubic baseline on the card
     and the CPU, and ``evaluate_model`` on fast-mode ``xla`` and
     ``pallas_int8`` resolvers (and a reading of the uncalibrated int8
     tree, not held), on fast-mode bf16 ``xla``, ``pallas`` and
     ``pallas_chain`` resolvers (bf16 launches counted), on fast-mode
     ``xla`` resolvers in the mixed profiles (against JAX's own rows on the
     CPU, ``EVAL_BF16_CPU.json``; K3 counted), on a split-mode bf16
     ``xla`` resolver (against the fast-mode bf16 row), and on fast-mode
     ``--forward int8`` resolvers (default, ``int8_dynamic_tail``,
     ``IEK_INT8_ACC=s32``; X1-X3 counted) against JAX's op-by-op rows on the
     CPU (``EVAL_INT8_CPU.json``), the TPU's rows on SSIM-Y and, for the
     default, the fast bf16 ``xla`` row; against each other and the
     recorded rows;
  5. the rest of the zoo (didbl_subpixel, difv4, difvdsr) with their
     committed demo checkpoints: X4 (``csrc/int8_conv.cu``, its 15 conv
     functions on wgmma) at every shape of the zoo's int8 forwards,
     in the block forms the zoo runs (difv4 256->256 at LR, 2x and 4x:
     conv_a's codes, conv_b + combine; difvdsr 192->192 at HR: conv_a's
     codes, conv_b's t and codes of d, conv_c from codes to codes, conv_d +
     combine) and the float32 entry (the subpixel head 128->2048, static
     and dynamic; difv4's and difvdsr's convs with bf16 and float32 x),
     bit-equal to their plain versions under the bf16 and s32 accumulators,
     with times, device ms, ``torch._int_mm`` over im2col and the bound;
     K3 at factor 2, C = 256, bf16 and float32, bit-equal; ``main_dirpath
     --model M`` on the seeded 128x128 BMP, ``--forward xla`` and
     ``--forward int8 --dtype bfloat16``, launches checked (X4 1 on
     didbl_subpixel; codes 32 + light 32 on difv4; codes 384, diff_b 192,
     diff_d 192 on difvdsr; K3 2 and 4, X1 18, X2 6), the int8 runs
     byte-equal with the plain X4 (X1/X2) and difv4's plain x2 swapped in;
     profiles hold difv4's and difvdsr's int8 forwards to fewer torch
     elementwise launches than blocks (no combine in plain torch); the subpixel head's
     dynamic form (``int8_dynamic_tail``: X4 dynamic 1, X3 2), byte-equal
     with its plain blocks; each model on a 16x16 crop against the CPU
     (int8: byte-equal with the pre-upscale and the bf16 convs taken from
     the CPU); profiles of both forwards per model; Set5 fast float32
     against ``EVAL_ZOO.json`` (under the Y of each row's provenance) and
     JAX on the CPU, int8 on the first two images against JAX op by op
     (``EVAL_ZOO_INT8_CPU.json``), the TPU's subpixel row and the card's
     float32 row on SSIM-Y.
  6. training: ``cli.learn`` fine-tunes the full-width didbl from the demo
     checkpoint (seeded as the state at step 0 of a checkpoint directory,
     so that ``--resume`` starts from it) at the CLI's defaults (batch 10,
     HR 96, float32, ``--monitor val_ssim_y``) on the bundled photos, with
     Set5 as validation: 2 epochs of 3 steps, then ``--resume --epochs 3``,
     K3 counted exactly (one launch per train step, per validation batch and
     per image-metric forward), the epoch and step numbering checked; the
     checkpoint's npz export and its ``latest/`` served by ``main_dirpath``,
     byte-equal; one full-width train step on K3 and one on the plain x4
     (cuDNN deterministic), loss and every gradient leaf bit-equal; K3's
     gradient (the registered backward of ``iek::upsample_phase_tf1``) against the plain autograd, bit for bit, at x4
     C = 128 and x2 C = 256 in float32 and bf16, with the plain backward's
     time; a narrow step on the card against the CPU within the CPU tests'
     bounds; ``learn --dtype bfloat16`` (K3's bf16 form counted); the median
     train step and a profile of 3 (device ms by kernel, idle share, peak
     memory) in float32 and bf16; ``main_dirpath --internal-learn 4`` under
     ``xla`` and ``int8``, launches against the same run without it, and on
     an engine the base module, params and int8 scales restored and the next
     image equal to a fresh engine's.
  7. the serving runtime: 7a the native codec's build (or why it is not
     available: the compiler's or the loader's message) and its Set5 decode
     ms beside PIL's and the numpy decoder's, all decodes equal; 7b
     ``main_dirpath`` serial and ``--pipeline`` over 8 seeded 512x512 images
     and the Set5 LR images under ``--forward int8 --dtype bfloat16 --mode
     fast`` (X1 18, X2 6, K3 1 an image), and over the LR images under
     float32 ``xla`` patch mode, each pair byte-equal with the same
     launches, out-Mpix/s including IO and the device idle share of each
     loop, ``PipelineStats``; 7c ``--save_intermediate``: the intermediate
     equal to ``resize_pil_uint8`` of the input, skipped by a second run;
     7d ``export_model`` of the int8 fast program at 512x512 and the float32
     xla patch program at 128x128, both loaded by ``load_forward`` in one
     fresh subprocess that imports no model and no engine and makes every
     plain version the ops could reach raise: byte-equal to
     ``resolver.upscale``, X1 18 / X2 6 / K3 1 and K3 1 launched from as
     many ``iek::`` nodes, with the artifact's MB, load ms and ms an image
     beside ``resolver.upscale``'s; 7e ``python -m
     image_enhance_keras_tpu_torch upscale <dir> --forward int8`` exits 0.
  8. scale-out (``parallel/``) over every card when there are two or more,
     else over two entries of the one card (printed as the mesh): 8a
     ``ShardedResolver`` on the full-width didbl (demo weights) and a
     seeded 512x512 image, patch ``xla`` float32, fast and split2d
     (128/128) on the serving profile ``--forward int8 --dtype bfloat16``,
     fast with ``int8_dynamic_tail`` (X3's abs-maxes reduced over the
     bands), patch ``pallas_int8``, each against the single-device
     resolver (patch byte-equal, banded modes within one level, the count
     of differing values printed), out-Mpix/s and launches of both, and
     ``upscale_patch_average`` at ``compat``'s geometries (patch 32 at step
     4 and 16, a seeded 96x96) against one device, byte-equal; 8b one
     float32 data-parallel train step (batch 10, HR 96, the bundled
     photos) against the single-device step (loss within 1e-5, params
     within 1e-6 where the gradient is not below 1e-6, the lr there), ms a
     step of both; 8c the data-parallel step in a child process through an
     NCCL process group joined by ``maybe_init_distributed`` (one rank:
     bit-equal to the step without a group, cuDNN deterministic; two ranks
     on two cards where there are two), and ``learn`` / ``main_dirpath
     --devices`` one more than the cards exiting non-zero with the mesh's
     "requested N devices, have M".
  9. the long tail: 9a ``compat.DifvdsrDouble`` on the card with the demo
     weights: upscaleStepPatch on a seeded 128x128 file byte-equal to
     ``SuperResolver.upscale_file``, upscalePatch (step 4) and the legacy
     upscale (step 16) on a seeded 64x64 file byte-equal to
     ``upscale_patch_average``, upVideo to ``upscale_frame``, K3 launches
     and ms of each; 9b ``--forward int8 --dtype bfloat16`` under
     ``IEK_INT8_MERGE55`` (bf16 and s32 accumulators, each byte-equal to
     the unmerged run), ``IEK_INT8_UPQ`` (K3q 1, X1u 1, X1 17, K3 0; byte-
     equal to itself on the plain x4, K3q and blocks) and
     ``IEK_INT8_UPMM`` (no K3) at 128x128 in patch mode and 512x512 in fast
     mode, launches and ms per image; K3q and X1u at (9,96,96,128) ->
     (9,384,384,128) on the forward's own activations, bit-equal to their
     plain versions, with ms, device ms, bounds (K3q: bytes) and X1u's
     ``torch._int_mm`` route; Set5 fast int8 under each knob within SSIM-Y
     1e-3 of the default; 9c every resize method and ``uniform_filter``
     on the card against the CPU, ``winograd_conv2d_same`` F(2,3) against
     ``F.conv2d`` (TF32 off) at (9,96,96,128) with both times, and
     ``utils.profiling.trace`` writing a Chrome trace with the card's
     kernels.
Prints the kernels as one JSON line, then the card's name and power limit,
then the ``{"ok": true, ...}`` line last.  Exits non-zero, before printing
any of those, when CUDA is missing, the package is not beside this script,
or any check fails.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
SHAPE = (9, 96, 96, 128)
#: kernel vs plain version on the card: float32 sums over 128*68 terms in
#: another order, on activations of order 1-10
KERNEL_ATOL = 2e-5
#: chain kernels against their plain versions and the per-block kernels:
#: 16 (or 6) float32 blocks summed in other orders (tests/test_pallas_tower.py)
CHAIN_ATOL = 5e-5
#: uint8 outputs of two float32 forwards that sum in other orders
U8_MAX_DIFF = 1
U8_MAX_FRAC = 1e-3
#: int8 kernels and the upsample against their plain versions: they repeat
#: the same exact integer sums and rounded float steps, so each must be
#: bit-equal (torch.equal)
#: ragged crops (N, H, W) of the int8 path's LR input for K4 and K5, with
#: widths above and below one 64-column tile (Set5's LR widths run 57-128)
INT8_RAGGED = ((0, 57, 86), (1, 70, 70), (2, 86, 57), (3, 5, 70), (4, 8, 64))
#: uint8 outputs of two int8 forwards (tests/test_split_mode.py:97-98)
INT8_U8_MAX_DIFF, INT8_U8_MAX_FRAC = 3, 0.05
#: ragged crops (N, H, W) of the float32 kernels' inputs for K1, K2, K6 and
#: K7: widths above and below one 16-column tile of their 3xTF32 conv tile
F32_RAGGED = ((0, 57, 86), (1, 86, 57), (2, 57, 57), (3, 5, 70), (4, 8, 64))
#: H100 SXM data sheet: float32 on the CUDA cores, dense TF32 and int8 tensor
#: cores, HBM3 rate.  Float32-accurate work on the TF32 tensor cores takes
#: three products (3xTF32), so its bound is 3 x FLOP / PEAK_TF32_FLOPS; the
#: TFLOP/s reported count the useful FLOP only.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_S = 3.35e12
MIN_TIMED = 12
#: Set5 x4 (phase 4): xla and pallas_chain through scorpath against each
#: other (float32 forwards that sum in other orders), and every score
#: against its recorded row (EVAL_RESULTS.json, EVAL_PROFILES.json); those
#: rows came from TPU runs at default precision, so the bounds allow for it
SET5_PAIR_DB, SET5_PAIR_SSIM = 0.002, 1e-5
SET5_DB, SET5_SSIM = 0.05, 5e-4
BICUBIC_DB = 1e-3
#: pallas_int8 on Set5, calibrated on the package-bundled photos (the port
#: carries copies), against the recorded pallas_int8 row calibrated on the
#: same photos, and against the --forward int8 row (SSIM-Y only)
INT8_SSIM = 1e-3
#: bf16 kernels (K1, K2; K6, K7 with K = 1) against their plain bf16 versions,
#: both summing in float32 in other orders: at most BF16_FRAC of the elements
#: differ, each by as many bf16 ulps of its magnitude as the output has
#: roundings a flipped intermediate can move (a block's float32 combine
#: rounds once; a chain's bf16(res*y) and final sum twice), the magnitude
#: counted as at least BF16_NEAR_ZERO * max|plain| for a block (outputs near
#: zero are sums that cancelled) and res * max|plain| for a chain (its branch
#: sums round at their own magnitude and enter scaled by res)
#: (bf16.ulp_gaps; tests/test_torch_bf16.py)
BF16_FRAC, BF16_NEAR_ZERO, BF16_CHAIN_NEAR_ZERO = 1e-3, 2.0 ** -6, 0.1
BF16_BLOCK_ULPS, BF16_CHAIN_ULPS = 1.0, 2.0
#: the full bf16 chains, and the bf16 CLI outputs: the kernels' gap to the
#: plain versions (mean and max |d|; uint8: share and max) within this many
#: times the yardstick, the gap between the plain versions summed in float64
#: and in float32 (the same rounding points).  22 bf16 blocks amplify any
#: difference in summation order: the uint8 outputs of the two plain
#: versions differ on a sixth of the values, by up to 2 levels
BF16_YARDSTICK_TIMES = 2.0
#: Set5 fast bf16, held against JAX's own bf16 forwards on the CPU
#: (EVAL_BF16_CPU.json, scripts/eval_bf16_set5_cpu.py) at SET5_DB / SET5_SSIM;
#: against the TPU's recorded bf16_fast_5img row, SSIM-Y within SET5_SSIM for
#: xla and BF16_KERNEL_SSIM for pallas and pallas_chain (whose x4 is the dense
#: contraction, not the phase upsample).  The row's PSNR-Y is not held: the
#: TPU's bf16 arithmetic differs from JAX's on the CPU, whose xla bf16 scores
#: 35.08 dB against the row's 35.23
BF16_KERNEL_SSIM = 1e-3
#: split mode (phase 3c): a SPLIT_HW square image, stripes of SPLIT_TILE body
#: rows, 2-D tiles of SPLIT2D_TILE (16 tiles: two chunks of the engine's 8)
SPLIT_HW, SPLIT_TILE, SPLIT2D_TILE = 512, 64, 128
#: Set5 split-mode bf16 xla against the fast-mode bf16 xla row of the same run
SPLIT_SET5_DB = 0.01


def _phase(name: str, t0: float) -> None:
    print(f"[chip_smoke] {name}: {time.time() - t0:.2f} s", flush=True)


def _gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


#: the bf16 tile's copies in SASS: TMA tensor loads (the windows) and bulk
#: copies (the weight slots)
SASS_COPY_OPS = ("UTMALDG", "UBLKCP")


def _sass_counts(so_path: str) -> dict:
    """Lines of the library's SASS with a GMMA (wgmma) and an IDP (dp4a)
    instruction, by ``cuobjdump`` beside nvcc or on PATH, in all and per
    kernel function (``functions``: mangled name -> GMMA lines; ``ops``:
    mangled name -> lines of each SASS_COPY_OPS); raises where it cannot be
    found, so that the check never passes unrun."""
    from image_enhance_keras_tpu_torch.ops.cuda import _build

    beside = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    tool = beside if os.path.isfile(beside) else shutil.which("cuobjdump")
    if tool is None:
        raise RuntimeError(f"cuobjdump is neither at {beside} nor on PATH")
    sass = subprocess.run([tool, "--dump-sass", so_path], check=True, capture_output=True,
                          text=True, timeout=120).stdout.splitlines()
    counts = {op: sum(op in line for line in sass) for op in ("GMMA", "IDP")}
    functions: dict = {}
    ops: dict = {}
    name = None
    for line in sass:
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            functions[name] = 0
            ops[name] = dict.fromkeys(SASS_COPY_OPS, 0)
        elif name is not None:
            functions[name] += "GMMA" in line
            for op in SASS_COPY_OPS:
                ops[name][op] += op in line
    counts["functions"] = functions
    counts["ops"] = ops
    return counts


def _gmma_lines(functions: dict, row: str, functions4: dict | None = None) -> int:
    """GMMA lines in the SASS of the int8 kernel functions that a phase-2 row
    (``light53_int8``, ``light_int8_dynamic_f32``, ...) launches, matched on
    their mangled names: the kernel, then its activation type and, for the
    dynamic kernels, the Light53 flag.  X1 and X2 run on csrc/int8_conv.cu
    (``functions4``): two launches each of ``xla_block_kernel`` (X1's forms
    0 and 1, X2's 2 and 3)."""
    if "_xla" in row:  # the XLA int8 forms: bf16 only
        if row.startswith("light53_int8_xla_dyn"):  # the accumulator mode as Li1 / Li2
            parts = ["xdyn_first_kernel", "xdyn_second_kernel"]
        else:
            functions = functions4 or {}
            parts = (["xla_block_kernelILi0E", "xla_block_kernelILi1E"] if row.startswith("light53")
                     else ["xla_block_kernelILi2E", "xla_block_kernelILi3E"])
        return sum(v for k, v in functions.items() for p in parts if p in k)
    t = "If" if row.endswith("_f32") else "I13__nv_bfloat16"
    if "dynamic" in row:
        flag = "Lb1" if row.startswith("light53") else "Lb0"
        parts = [f"dyn_first_kernel{t}{flag}", f"dyn_second_kernel{t}{flag}"]
    else:
        second = "light53_i8_second_kernel" if row.startswith("light53") else "light_i8_second_kernel"
        parts = [f"i8_first_kernel{t}", f"{second}{t}Li0E"]
    return sum(v for k, v in functions.items() for p in parts if p in k)


def _launch_events(fn, iters: int = 3) -> dict:
    """Device ms per call and the events seen, ``[ms, events]``, of each kernel
    (and memset) that ``fn`` launches, under ``torch.profiler``, after one
    warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from image_enhance_keras_tpu_torch.utils.profiling import device_kernel_times

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name, ms, calls in device_kernel_times(prof):
        short = name.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]
        got = out.setdefault(short, [0.0, 0])
        got[0] += ms / iters
        got[1] += calls
    return out


def _launch_breakdown(fn, iters: int = 3) -> dict:
    """Device ms per call of each kernel (and memset) that ``fn`` launches,
    under ``torch.profiler``, after one warm-up call."""
    return {k: ms for k, (ms, _) in _launch_events(fn, iters).items()}


def _queued_ms(fn, n: int = 20) -> float:
    """Device ms per call of ``fn`` without the host: ``n`` calls queued behind
    a spin kernel (``torch.cuda._sleep``), so that the card runs them back to
    back, between two CUDA events.  The fallback of :func:`_device_ms`."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # tens of ms: longer than the host takes to queue the calls
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _device_ms(fn, bound_ms: float = 0.0, record: dict | None = None) -> tuple[float, str]:
    """Device ms per call of ``fn``, and which reading it is: the sum of its
    launches under ``torch.profiler`` where that is not below ``bound_ms``, the
    least time the card can take for the work; else (the profiler handed back
    no device event, or lost some) the queued CUDA-event time
    (:func:`_queued_ms`).  ``record``, where given, gets both readings and the
    profiler's count of events."""
    events = _launch_events(fn)
    prof = sum(ms for ms, _ in events.values())
    valid = prof > 0 and prof >= bound_ms
    queued = _queued_ms(fn) if record is not None or not valid else None
    if record is not None:
        record.update(profiler_ms=prof, profiler_events=sum(n for _, n in events.values()), queued_ms=queued)
    return (prof, "torch.profiler") if valid else (queued, "queued CUDA events")


def _time_ms(fn, iters: int = MIN_TIMED, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _seeded_image(h: int, w: int, seed: int):
    """Smooth colour gradients and stripes plus noise, uint8 RGB."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    r = 40 + 170 * xx / max(w - 1, 1)
    g = 40 + 170 * yy / max(h - 1, 1)
    b = 128 + 90 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    img = np.stack([r, g, b], axis=-1) + rng.normal(0.0, 12.0, (h, w, 3))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _u8_agreement(a, b) -> tuple[int, float]:
    import numpy as np

    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


def _psnr(a, b) -> float:
    import numpy as np

    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _bound(ops: float, peak_ops: float, nbytes: float) -> tuple[float, str]:
    """Least time on the card (ms) and what bounds it."""
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _f32_bounds(flops: float, nbytes: float) -> dict:
    """Both bounds of a float32 kernel (ms): float32 FMA on the CUDA cores and
    3xTF32 on the tensor cores; ``bound_ms`` is the lesser, the least time
    the card could take for float32-accurate work."""
    cores, cores_by = _bound(flops, PEAK_F32_FLOPS, nbytes)
    tc, tc_by = _bound(3.0 * flops, PEAK_TF32_FLOPS, nbytes)
    best, by = (tc, tc_by) if tc <= cores else (cores, cores_by)
    return {"bound_ms": best, "bound_by": by, "bound_f32_cores_ms": cores, "bound_tf32x3_ms": tc}


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _y_tpu_default(rgb):
    """The Y channel as the JAX scorer computes it on a TPU at default
    precision: its einsum rounds x/255 and the BT.601 row to bfloat16 and
    sums in float32.  The quality rows of EVAL_RESULTS.json and
    EVAL_PROFILES.json were scored so (the bicubic row, 28.420074, is
    reproduced by it; exact float32 gives 28.4477)."""
    import torch

    x = (rgb.to(torch.float32) / 255.0).to(torch.bfloat16).to(torch.float32)
    m = torch.tensor([65.481, 128.553, 24.966]).to(torch.bfloat16).to(torch.float32)
    return x[..., 0] * m[0] + x[..., 1] * m[1] + x[..., 2] * m[2] + 16.0


def _scored(run, crop: int = 10):
    """Run ``run()`` (an evaluation through ``eval.evaluate``) and return its
    (per-image scores, means) and the means of the same pairs scored with
    the TPU's default-precision Y (:func:`_y_tpu_default`)."""
    import numpy as np
    import torch

    from image_enhance_keras_tpu_torch.eval import evaluate
    from image_enhance_keras_tpu_torch.ops.metrics import psnr_nitre, ssim

    pairs, orig = [], evaluate.score_pair

    def record(gt, sr, **kw):
        pairs.append((gt, sr))
        return orig(gt, sr, **kw)

    evaluate.score_pair = record
    try:
        result = run()
    finally:
        evaluate.score_pair = orig
    ps, ss = [], []
    for gt, sr in pairs:
        g = _y_tpu_default(torch.from_numpy(np.array(gt[crop:-crop, crop:-crop])).cuda())
        p = _y_tpu_default(torch.from_numpy(np.array(sr[crop:-crop, crop:-crop])).cuda())
        ps.append(float(psnr_nitre(p, g)))
        ss.append(float(ssim(p, g, data_range=255.0)))
    return result, {"psnr_y": float(np.mean(ps)), "ssim_y": float(np.mean(ss))}


def _set5_phase(failures: list) -> dict:
    """scorpath --generate (xla, pallas_chain) and evaluate_model (bicubic,
    fast xla, fast pallas_int8) on data_set5, against each other, a CPU run
    and the recorded quality rows.  The PNGs are read by the port's numpy
    decoder (held bit-equal to PIL first where PIL is installed)."""
    import numpy as np

    from image_enhance_keras_tpu_torch.data import io as pio

    pil = pio._pil
    if pil() is not None:
        for p in pio.list_images(os.path.join(HERE, "data_set5")):
            with pil().open(p) as im:
                same = np.array_equal(pio._png_read(p), np.asarray(im.convert("RGB")))
            print(f"[chip_smoke] numpy PNG decoder vs PIL on {os.path.basename(p)}: bit-equal {same}", flush=True)
            if not same:
                failures.append(f"numpy PNG decoder differs from PIL on {os.path.basename(p)}")
    native = pio._native
    pio._pil = pio._native = lambda: None
    try:
        return _set5_scores(failures)
    finally:
        pio._pil, pio._native = pil, native


def _set5_scores(failures: list) -> dict:
    import numpy as np
    import torch

    from image_enhance_keras_tpu_torch.cli import scorpath
    from image_enhance_keras_tpu_torch.data import io as pio
    from image_enhance_keras_tpu_torch.engine import SuperResolver
    from image_enhance_keras_tpu_torch.eval import BicubicResolver, evaluate_model
    from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights
    from image_enhance_keras_tpu_torch.ops.cuda import blocks as kb
    from image_enhance_keras_tpu_torch.ops.cuda import tower as kt
    from image_enhance_keras_tpu_torch.tiling.tiles import plan_tiles

    set5 = os.path.join(HERE, "data_set5")
    with open(os.path.join(HERE, "EVAL_RESULTS.json")) as f:
        rows = json.load(f)
    with open(os.path.join(HERE, "EVAL_PROFILES.json")) as f:
        profiles = json.load(f)
    decoder = "PIL" if pio._pil() is not None else "the port's numpy PNG decoder"
    print(f"[chip_smoke] Set5 PNGs are read by {decoder} (data/io.py _png_read)", flush=True)
    out: dict = {"png_decoder": decoder}

    def report(label, exact, tpu, ref=None):
        ref_s = f"; recorded {ref['psnr_y']:.4f} / {ref['ssim_y']:.5f}" if ref else ""
        print(f"[chip_smoke] Set5 {label}: PSNR-Y {exact['psnr_y']:.4f} SSIM-Y {exact['ssim_y']:.5f} "
              f"(float32 Y); {tpu['psnr_y']:.4f} / {tpu['ssim_y']:.5f} (TPU default-precision Y){ref_s}",
              flush=True)
        out[label] = {"exact": exact, "tpu_default_y": tpu, "recorded": ref}

    def check_row(label, tpu, ref, db, ssim_tol):
        dp, ds = abs(tpu["psnr_y"] - ref["psnr_y"]), abs(tpu["ssim_y"] - ref["ssim_y"])
        if dp > db or ds > ssim_tol:
            failures.append(f"Set5 {label}: {tpu['psnr_y']:.4f} / {tpu['ssim_y']:.5f} vs recorded "
                            f"{ref['psnr_y']:.4f} / {ref['ssim_y']:.5f} (bounds {db} dB, {ssim_tol})")

    # scorpath --generate in patch mode (the CLI default), xla and pallas_chain
    tmp = tempfile.mkdtemp(prefix="iek_chip_smoke_set5_")
    cli = {}
    try:
        lr_shapes = []
        for p in pio.list_images(set5):
            h, w = pio.imread(p).shape[:2]
            lr_shapes.append((h // 4, w // 4))
        chunks = sum(-(-plan_tiles(h, w, patch=96, step=64, scale=4, crop=8).n_tiles // 16)
                     for h, w in lr_shapes)
        for fwd in ("xla", "pallas_chain"):
            counted = (kb.fused_light53_block, kb.fused_light_block, kt.fused_light53_chain, kt.fused_light_chain)
            for fn in counted:
                fn.launches = 0
            path = os.path.join(tmp, f"{fwd}.json")
            (rc, tpu) = _scored(lambda: scorpath.main([set5, "--generate", "--forward", fwd, "--json", path]))
            launches = [fn.launches for fn in counted]
            if rc != 0:
                failures.append(f"scorpath --generate --forward {fwd} returned {rc}")
                continue
            with open(path) as f:
                cli[fwd] = json.load(f)
            report(f"scorpath --generate --forward {fwd}", cli[fwd], tpu, rows["didbl"])
            check_row(f"{fwd} patch", tpu, rows["didbl"], SET5_DB, SET5_SSIM)
            want = [0, 0, chunks, chunks] if fwd == "pallas_chain" else [0, 0, 0, 0]
            print(f"[chip_smoke] scorpath --forward {fwd} launches (K1, K2, K6, K7): {launches}, "
                  f"expected {want}", flush=True)
            if launches != want:
                failures.append(f"scorpath --forward {fwd} launches {launches} != {want}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if len(cli) == 2:
        dp = abs(cli["xla"]["psnr_y"] - cli["pallas_chain"]["psnr_y"])
        ds = abs(cli["xla"]["ssim_y"] - cli["pallas_chain"]["ssim_y"])
        print(f"[chip_smoke] Set5 xla vs pallas_chain: {dp:.3g} dB PSNR-Y, {ds:.3g} SSIM-Y "
              f"(bounds {SET5_PAIR_DB}, {SET5_PAIR_SSIM})", flush=True)
        if dp > SET5_PAIR_DB or ds > SET5_PAIR_SSIM:
            failures.append(f"Set5 xla vs pallas_chain differ by {dp:.3g} dB, {ds:.3g} SSIM-Y")

    # the bicubic baseline, on the card and on the CPU
    (_, exact), tpu = _scored(lambda: evaluate_model(BicubicResolver(4), set5, verbose=False))
    _, cpu = evaluate_model(BicubicResolver(4, device="cpu"), set5, verbose=False)
    report("bicubic", exact, tpu, rows["bicubic"])
    check_row("bicubic", tpu, rows["bicubic"], BICUBIC_DB, SET5_SSIM)
    print(f"[chip_smoke] Set5 bicubic card vs CPU: {abs(exact['psnr_y'] - cpu['psnr_y']):.3g} dB", flush=True)
    if abs(exact["psnr_y"] - cpu["psnr_y"]) > 1e-4:
        failures.append(f"Set5 bicubic card {exact['psnr_y']:.6f} vs CPU {cpu['psnr_y']:.6f} dB")

    # evaluate_model on fast-mode resolvers: f32 xla, and pallas_int8
    weights = resolve_default_weights(MODEL_REGISTRY["didbl"])
    (_, exact), tpu = _scored(lambda: evaluate_model(
        SuperResolver(weights=weights, forward="xla", mode="fast"), set5, verbose=False))
    report("fast xla", exact, tpu, profiles["f32_fast_5img"])
    check_row("fast xla", tpu, profiles["f32_fast_5img"], SET5_DB, SET5_SSIM)
    # pallas_int8 with the engine's default calibration, the package-bundled
    # photos, which the recorded pallas_int8 row (int8_pallas_fast_5img) was
    # calibrated on; int8_fast_excal_5img is --forward int8 (per-channel
    # scales folded into the weights, procedural calibration), held on SSIM-Y
    r8 = SuperResolver(weights=weights, forward="pallas_int8", mode="fast")
    (_, exact), tpu = _scored(lambda: evaluate_model(r8, set5, verbose=False))
    out["int8_calib_source"] = r8.int8_calib_source
    ref_p, ref_x = profiles["int8_pallas_fast_5img"], profiles["int8_fast_excal_5img"]
    report(f"fast pallas_int8 (calibration: {r8.int8_calib_source})", exact, tpu, ref_p)
    print(f"[chip_smoke] int8_fast_excal_5img (--forward int8, procedural calibration): "
          f"{ref_x['psnr_y']:.4f} / {ref_x['ssim_y']:.5f}; this run's SSIM-Y is "
          f"{abs(tpu['ssim_y'] - ref_x['ssim_y']):.3g} from it (bound {INT8_SSIM})", flush=True)
    if r8.int8_calib_source != "package-bundled real photos":
        failures.append(f"Set5 fast pallas_int8 calibrated on {r8.int8_calib_source}, not the bundled photos")
    check_row("fast pallas_int8", tpu, ref_p, SET5_DB, INT8_SSIM)
    if abs(tpu["ssim_y"] - ref_x["ssim_y"]) > INT8_SSIM:
        failures.append(f"Set5 fast pallas_int8 SSIM-Y {tpu['ssim_y']:.5f} vs int8_fast_excal_5img "
                        f"{ref_x['ssim_y']:.5f} (bound {INT8_SSIM})")
    # the uncalibrated int8 forward (no activation scales: K4/K5 quantize every
    # window dynamically) over whole frames, beside the calibrated one: a
    # reading, not held (no recorded row exists for it)
    from image_enhance_keras_tpu_torch.models.didbl_pallas import quantize_didbl_params
    from image_enhance_keras_tpu_torch.ops.cuda import int8_blocks as ki8

    ru = SuperResolver(weights=weights, forward="pallas_int8", mode="fast")
    ru._qparams = quantize_didbl_params(ru.params)
    ki8.light53_int8.launches = ki8.light_int8.launches = 0
    (_, exact_u), tpu_u = _scored(lambda: evaluate_model(ru, set5, verbose=False))
    launches_u = [ki8.light53_int8.launches, ki8.light_int8.launches]
    report("fast pallas_int8 uncalibrated (dynamic scales)", exact_u, tpu_u)
    print(f"[chip_smoke] Set5 fast pallas_int8 uncalibrated against calibrated: "
          f"{tpu_u['psnr_y'] - tpu['psnr_y']:+.4f} dB, {tpu_u['ssim_y'] - tpu['ssim_y']:+.2e} SSIM-Y "
          f"(TPU Y); launches (K4, K5) {launches_u}", flush=True)
    if launches_u != [18 * len(lr_shapes), 6 * len(lr_shapes)]:
        failures.append(f"Set5 fast uncalibrated pallas_int8 launches (K4, K5) {launches_u}")

    # the bf16 profile in fast mode, held against JAX's bf16 forwards on the
    # CPU (EVAL_BF16_CPU.json) and, on SSIM-Y, against the TPU's
    # bf16_fast_5img; one bf16 K1 per Light53 block and image, one K6 per image
    ref_b = profiles["bf16_fast_5img"]
    with open(os.path.join(HERE, "EVAL_BF16_CPU.json")) as f:
        jax_cpu = json.load(f)
    n_img = len(lr_shapes)
    counted = (kb.fused_light53_block, kb.fused_light_block, kt.fused_light53_chain, kt.fused_light_chain)
    want = {"xla": [0, 0, 0, 0], "pallas": [16 * n_img, 6 * n_img, 0, 0], "pallas_chain": [0, 0, n_img, n_img]}
    for fwd in ("xla", "pallas", "pallas_chain"):
        for fn in counted:
            fn.bf16_launches = 0
        (_, exact), tpu = _scored(lambda: evaluate_model(
            SuperResolver(weights=weights, forward=fwd, mode="fast", dtype=torch.bfloat16), set5, verbose=False))
        launches = [fn.bf16_launches for fn in counted]
        ref_j = jax_cpu[f"jax_{fwd}"]["tpu_default_y"]
        report(f"fast {fwd} --dtype bfloat16", exact, tpu, ref_j)
        print(f"[chip_smoke] Set5 fast {fwd} bf16 against the TPU's bf16_fast_5img {ref_b['psnr_y']:.4f} / "
              f"{ref_b['ssim_y']:.5f}: {tpu['psnr_y'] - ref_b['psnr_y']:+.4f} dB, "
              f"{tpu['ssim_y'] - ref_b['ssim_y']:+.2e} SSIM-Y; launches (K1, K2, K6, K7): {launches}, "
              f"expected {want[fwd]}", flush=True)
        out[f"fast {fwd} --dtype bfloat16"]["tpu_row"] = ref_b
        if launches != want[fwd]:
            failures.append(f"Set5 fast {fwd} bf16 launches {launches} != {want[fwd]}")
        check_row(f"fast {fwd} bf16 against JAX on the CPU", tpu, ref_j, SET5_DB, SET5_SSIM)
        ssim_tol = SET5_SSIM if fwd == "xla" else BF16_KERNEL_SSIM
        if abs(tpu["ssim_y"] - ref_b["ssim_y"]) > ssim_tol:
            failures.append(f"Set5 fast {fwd} bf16 SSIM-Y {tpu['ssim_y']:.5f} vs bf16_fast_5img "
                            f"{ref_b['ssim_y']:.5f} (bound {ssim_tol})")
        if fwd == "xla":
            fast_bf16 = (exact, tpu)

    # the mixed profiles in fast mode on xla, held against JAX's own mixed
    # forwards on the CPU (EVAL_BF16_CPU.json) under both Ys, and on SSIM-Y
    # against the TPU's mixed_fast_5img / mixedtail_fast_5img; one K3 per
    # image, the float32 form under mixed, the bf16 form under mixed-tail
    from image_enhance_keras_tpu_torch.ops.cuda import upsample as kup

    k3 = kup.upsample_phase_tf1_kernel
    for label, mixed, key, tpu_key in (("mixed", True, "xla_mixed", "mixed_fast_5img"),
                                       ("mixed-tail", "tail", "xla_mixedtail", "mixedtail_fast_5img")):
        k3.launches = k3.bf16_launches = 0
        (_, exact), tpu = _scored(lambda: evaluate_model(
            SuperResolver(weights=weights, forward="xla", mode="fast", mixed=mixed), set5, verbose=False))
        launches = [k3.launches, k3.bf16_launches]
        want_k3 = [n_img, n_img if mixed == "tail" else 0]
        ref_j, ref_t = jax_cpu[f"jax_{key}"], profiles[tpu_key]
        report(f"fast xla --dtype {label}", exact, tpu, ref_j["tpu_default_y"])
        print(f"[chip_smoke] Set5 fast xla {label}: exact Y {exact['psnr_y'] - ref_j['exact']['psnr_y']:+.4f} dB, "
              f"{exact['ssim_y'] - ref_j['exact']['ssim_y']:+.2e} SSIM-Y from JAX on the CPU; against the TPU's "
              f"{tpu_key} {ref_t['psnr_y']:.4f} / {ref_t['ssim_y']:.5f}: {tpu['psnr_y'] - ref_t['psnr_y']:+.4f} dB, "
              f"{tpu['ssim_y'] - ref_t['ssim_y']:+.2e} SSIM-Y; K3 launches (all, bf16) {launches}, expected "
              f"{want_k3}", flush=True)
        out[f"fast xla --dtype {label}"]["tpu_row"] = ref_t
        out[f"fast xla --dtype {label}"]["jax_cpu_exact"] = ref_j["exact"]
        if launches != want_k3:
            failures.append(f"Set5 fast xla {label} K3 launches {launches} != {want_k3}")
        check_row(f"fast xla {label} against JAX on the CPU", tpu, ref_j["tpu_default_y"], SET5_DB, SET5_SSIM)
        check_row(f"fast xla {label} against JAX on the CPU (exact Y)", exact, ref_j["exact"], SET5_DB, SET5_SSIM)
        if abs(tpu["ssim_y"] - ref_t["ssim_y"]) > SET5_SSIM:
            failures.append(f"Set5 fast xla {label} SSIM-Y {tpu['ssim_y']:.5f} vs {tpu_key} "
                            f"{ref_t['ssim_y']:.5f} (bound {SET5_SSIM})")

    # the bf16 serving default, split mode on xla: within SPLIT_SET5_DB of the
    # fast-mode bf16 xla row of this run; one K3 per stripe
    k3.launches = k3.bf16_launches = 0
    (_, exact), tpu = _scored(lambda: evaluate_model(
        SuperResolver(weights=weights, forward="xla", mode="split", dtype=torch.bfloat16), set5, verbose=False))
    stripes = sum(-(-h // 64) for h, _ in lr_shapes)
    report("split xla --dtype bfloat16", exact, tpu)
    dp = max(abs(exact["psnr_y"] - fast_bf16[0]["psnr_y"]), abs(tpu["psnr_y"] - fast_bf16[1]["psnr_y"]))
    print(f"[chip_smoke] Set5 split xla bf16 against fast xla bf16: {dp:.3g} dB PSNR-Y (bound {SPLIT_SET5_DB}); "
          f"K3 launches {k3.bf16_launches}, expected {stripes}", flush=True)
    if dp > SPLIT_SET5_DB or k3.bf16_launches != stripes or k3.launches != stripes:
        failures.append(f"Set5 split xla bf16: {dp:.3g} dB from fast, K3 launches {k3.launches} "
                        f"(bf16 {k3.bf16_launches}) != {stripes}")

    # --forward int8 (the XLA int8 serving profile) in fast mode, calibrated on
    # the bundled photos: against JAX's own forward run op by op on the CPU
    # (EVAL_INT8_CPU.json, scripts/eval_int8_set5_cpu.py) at SET5_DB /
    # SET5_SSIM under both Ys, against the TPU's rows on SSIM-Y (INT8_SSIM),
    # and the default against this run's fast bf16 xla row on SSIM-Y (INT8_SSIM,
    # the README's quality bar for int8 against bf16)
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as kx

    with open(os.path.join(HERE, "EVAL_INT8_CPU.json")) as f:
        jax8 = json.load(f)
    xk = (kx.light53_int8_xla, kx.light_int8_xla, kx.light53_int8_xla_dyn)
    qp8 = None
    for key, tpu_key, acc, dyn in (("default", "int8_fast_5img", "bf16", False),
                                   ("dyntail", "int8_fast_dyntail_5img", "bf16", True),
                                   ("s32acc", "int8_fast_s32acc_5img", "s32", False)):
        r = SuperResolver(weights=weights, forward="int8", mode="fast")
        r.int8_dynamic_tail = dyn
        if qp8 is not None:
            r._qparams = qp8
        saved = os.environ.get("IEK_INT8_ACC")
        os.environ["IEK_INT8_ACC"] = acc
        for fn in xk:
            fn.launches = 0
        try:
            (_, exact), tpu = _scored(lambda: evaluate_model(r, set5, verbose=False))
        finally:
            if saved is None:
                os.environ.pop("IEK_INT8_ACC")
            else:
                os.environ["IEK_INT8_ACC"] = saved
        if qp8 is None:
            qp8 = r._qparams
            out["int8_xla_calib_source"] = r.int8_calib_source
            if r.int8_calib_source != "package-bundled real photos":
                failures.append(f"Set5 fast int8 calibrated on {r.int8_calib_source}, not the bundled photos")
        launches = [fn.launches for fn in xk]
        want = [(16 if dyn else 18) * n_img, 6 * n_img, 2 * n_img if dyn else 0]
        ref_j, ref_t = jax8[f"jax_int8_{key}"], profiles[tpu_key]
        label = f"fast int8 {key}"
        report(label, exact, tpu, ref_j["op_by_op"]["tpu_default_y"])
        jit_t = ref_j["jitted"]["tpu_default_y"]
        print(f"[chip_smoke] Set5 {label}: against JAX op by op on the CPU "
              f"{tpu['psnr_y'] - ref_j['op_by_op']['tpu_default_y']['psnr_y']:+.4f} dB, "
              f"{tpu['ssim_y'] - ref_j['op_by_op']['tpu_default_y']['ssim_y']:+.2e} SSIM-Y; JAX jitted "
              f"{jit_t['psnr_y']:.4f} / {jit_t['ssim_y']:.5f}; the TPU's {tpu_key} {ref_t['psnr_y']:.4f} / "
              f"{ref_t['ssim_y']:.5f}: {tpu['ssim_y'] - ref_t['ssim_y']:+.2e} SSIM-Y; launches (X1, X2, X3) "
              f"{launches}, expected {want}", flush=True)
        out[label].update(tpu_row=ref_t, jax_cpu_exact=ref_j["op_by_op"]["exact"], jax_cpu_jitted=jit_t,
                          launches=launches)
        if launches != want:
            failures.append(f"Set5 {label} launches (X1, X2, X3) {launches} != {want}")
        check_row(f"{label} against JAX op by op on the CPU", tpu, ref_j["op_by_op"]["tpu_default_y"],
                  SET5_DB, SET5_SSIM)
        check_row(f"{label} against JAX op by op on the CPU (exact Y)", exact, ref_j["op_by_op"]["exact"],
                  SET5_DB, SET5_SSIM)
        if abs(tpu["ssim_y"] - ref_t["ssim_y"]) > INT8_SSIM:
            failures.append(f"Set5 {label} SSIM-Y {tpu['ssim_y']:.5f} vs {tpu_key} {ref_t['ssim_y']:.5f} "
                            f"(bound {INT8_SSIM})")
        if key == "default":
            ds = abs(tpu["ssim_y"] - fast_bf16[1]["ssim_y"])
            print(f"[chip_smoke] Set5 fast int8 against fast xla bf16 of this run: {ds:.3g} SSIM-Y "
                  f"(bound {INT8_SSIM})", flush=True)
            out[label]["ssim_y_vs_bf16_xla"] = ds
            if ds > INT8_SSIM:
                failures.append(f"Set5 fast int8 SSIM-Y {tpu['ssim_y']:.5f} vs bf16 xla "
                                f"{fast_bf16[1]['ssim_y']:.5f} (bound {INT8_SSIM})")
    return out


#: the XLA int8 forms (X1-X3) replace no TPU kernel: JAX runs them as XLA
#: convolutions; "replaces" names the JAX function
X_REPLACES = {"light53_int8_xla": "image_enhance_keras_tpu/models/didbl_pallas.py:415",
              "light_int8_xla": "image_enhance_keras_tpu/models/didbl_pallas.py:447",
              "light53_int8_xla_dyn": "image_enhance_keras_tpu/models/didbl_pallas.py:500"}
#: K3q and X1u (IEK_INT8_UPQ) replace no TPU kernel either: JAX's
#: _light53_i8_xla_upfused leaves the fused x4 + quantize and the block to XLA
K_UPQ_REPLACES = {"upsample_quant_tf1": "image_enhance_keras_tpu/models/didbl_pallas.py:683",
                  "light53_int8_xla_upq": "image_enhance_keras_tpu/models/didbl_pallas.py:675"}


def _int_mm_convs(pairs):
    """One call of the library route for a block's convs: each (codes, int8
    HWIO weights) as ``torch._int_mm`` over an int8 im2col (N*H*W x k*k*C),
    the s32 sums of the same convs (no dequant, no epilogue)."""
    import torch
    import torch.nn.functional as F

    def conv(q, w):
        k, c = int(w.shape[0]), int(q.shape[-1])
        cols = F.pad(q, (0, 0, k // 2, k // 2, k // 2, k // 2)).unfold(1, k, 1).unfold(2, k, 1)
        a = cols.permute(0, 1, 2, 4, 5, 3).reshape(-1, k * k * c)
        return torch._int_mm(a, w.reshape(k * k * c, -1)).view(*q.shape[:3], -1)

    def run():
        return [conv(q, w) for q, w in pairs]

    return run


def _int8_xla_kernels(qp, x8, sass8, sass4, failures: list, gpu: str) -> list:
    """Phase 2 of the XLA int8 forms on the int8 forward's own activations:
    the level1 output x8 (9,96,96,128) bf16 for X1, the 16 plain X1 blocks'
    output for X2, and the x4 of the 6 plain X2 blocks' output, (9,384,384,128),
    for X1 and X3 at HR.  Each bit-equal to its plain version under the bf16
    and s32 accumulators (and on the ragged crops of x8), its time per call
    (both accumulators), device ms per call (:func:`_device_ms`: the profiler's
    sum where it is not below the bound, else 20 calls queued behind a spin
    kernel; a reading below the bound fails) and per launch (the profiler;
    ``scripts/probe_x1_parts.py`` queues X1's launches one by one), GMMA lines (X1 and X2 in
    csrc/int8_conv.cu's SASS, ``sass4``), the bound (K4/K5's int8 operations
    over the int8 peak, x read and written once) and the library time:
    ``torch._int_mm`` over an int8 im2col of the block's convs."""
    import torch

    from image_enhance_keras_tpu_torch.models.didbl_pallas import _stacked_actc
    from image_enhance_keras_tpu_torch.ops.cuda import int8_blocks as ki8
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as kx
    from image_enhance_keras_tpu_torch.ops.resize import upsample_phase_plain

    l53, lt = ("conv_a1", "conv_a2", "conv_b1", "conv_b2"), ("conv_a", "conv_b")

    def wts(p, convs, w="qf", s="sf"):
        return [p[c][k] for c in convs for k in (w, s, "bias")]

    p53, pl, pt = qp["body53_0"], qp["light_0"], qp["tail53_0"]
    a53, al, at = _stacked_actc(p53, ("x", "a", "b")), _stacked_actc(pl, ("x", "t")), _stacked_actc(pt, ("x", "a", "b"))
    with torch.inference_mode():
        h = x8
        for i in range(16):
            p = qp[f"body53_{i}"]
            h = kx.light53_int8_xla_plain(h, *wts(p, l53), _stacked_actc(p, ("x", "a", "b")))
        xl = h
        for i in range(6):
            p = qp[f"light_{i}"]
            h = kx.light_int8_xla_plain(h, *wts(p, lt), _stacked_actc(p, ("x", "t")))
        xh = upsample_phase_plain(h, 4).contiguous()
        del h

        def codes(x, p, act, convs):
            """(codes, weights) of the block's convs: x's, then each branch intermediate's."""
            xq = kx._quant_c(x, act[0])
            out = []
            for j in range(0, len(convs), 2):
                w1, s1, b1, w2 = p[convs[j]]["qf"], p[convs[j]]["sf"], p[convs[j]]["bias"], p[convs[j + 1]]["qf"]
                tq = kx._first(xq, w1, s1, b1, act[1 + j // 2], "bf16", False)
                out += [(xq.to(torch.int8), w1), (tq.to(torch.int8), w2)]
            return out

        libs = {"lr53": codes(x8, p53, a53, l53), "lr": codes(xl, pl, al, lt), "hr53": codes(xh, pt, at, l53)}
        # the library route's sums against the exact ones (the first conv of each)
        for key, pairs in libs.items():
            q, w = pairs[0]
            same = bool(torch.equal(_int_mm_convs(pairs[:1])()[0].float(), ki8._conv_s32(q.float(), w)))
            print(f"[chip_smoke] torch._int_mm over im2col, {key} {tuple(q.shape)} k={w.shape[0]}: equal to the "
                  f"exact sums {same}", flush=True)
            if not same:
                failures.append(f"the _int_mm library route ({key}) differs from the exact conv sums")
    c = int(x8.shape[-1])
    specs = [
        # name, kernel(x, acc), plain(x, acc), input, taps, plain timing iters, library pairs
        ("light53_int8_xla", lambda x, a: kx.light53_int8_xla(x, *wts(p53, l53), a53, acc=a),
         lambda x, a: kx.light53_int8_xla_plain(x, *wts(p53, l53), a53, acc=a), x8, 68, MIN_TIMED, "lr53"),
        ("light_int8_xla", lambda x, a: kx.light_int8_xla(x, *wts(pl, lt), al, acc=a),
         lambda x, a: kx.light_int8_xla_plain(x, *wts(pl, lt), al, acc=a), xl, 18, MIN_TIMED, "lr"),
        ("light53_int8_xla_hr", lambda x, a: kx.light53_int8_xla(x, *wts(pt, l53), at, acc=a),
         lambda x, a: kx.light53_int8_xla_plain(x, *wts(pt, l53), at, acc=a), xh, 68, 3, "hr53"),
        ("light53_int8_xla_dyn", lambda x, a: kx.light53_int8_xla_dyn(x, *wts(pt, l53, "q", "s"), acc=a),
         lambda x, a: kx.light53_int8_xla_dyn_plain(x, *wts(pt, l53, "q", "s"), acc=a), xh, 68, 3, "hr53"),
    ]
    res = {}
    with torch.inference_mode():
        for name, kern, plain, x, taps, plain_iters, lib in specs:
            row = {"shape": list(x.shape), "dtype": "bfloat16"}
            for acc in ("bf16", "s32"):
                got, want = kern(x, acc), plain(x, acc)
                torch.cuda.synchronize()
                d = (got.float() - want.float()).abs()
                exact = bool(torch.equal(got, want))
                row[f"bit_equal_{acc}"], row[f"max_abs_err_{acc}"] = exact, d.max().item()
                if not exact:
                    failures.append(f"{name} (acc {acc}): kernel not bit-equal to plain (differ on "
                                    f"{(d > 0).float().mean().item():.3g} of values, max |diff| {d.max().item():.3g})")
                row[f"ms_{acc}"] = _time_ms(lambda: kern(x, acc))
                del got, want, d
            row["plain_ms"] = _time_ms(lambda: plain(x, "bf16"), iters=plain_iters, warmup=1)
            ops = 2.0 * taps * c * c * x[..., 0].numel()
            row["bound_ms"], row["bound_by"] = _bound(ops, PEAK_INT8_OPS, 4.0 * x.numel() + taps * c * c)
            row["library_ms"] = _time_ms(_int_mm_convs(libs[lib]), iters=3, warmup=1)
            row["launch_ms"] = _launch_breakdown(lambda: kern(x, "bf16"))
            row["device_ms"], row["device_ms_by"] = _device_ms(lambda: kern(x, "bf16"), row["bound_ms"], row)
            if row["device_ms"] < row["bound_ms"]:
                failures.append(f"{name}: {row['device_ms']:.4f} ms device ({row['device_ms_by']}) is below its "
                                f"bound {row['bound_ms']:.4f} ms: the reading or the bound is wrong")
            row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
            row["tops"] = ops / (row["ms_bf16"] * 1e-3) / 1e12
            row["sass_gmma"] = _gmma_lines((sass8 or {}).get("functions", {}), name,
                                           (sass4 or {}).get("functions", {}))
            if row["sass_gmma"] == 0:
                failures.append(f"{name}: no GMMA (wgmma) line in the SASS of its kernel functions")
            print(f"[chip_smoke] {name} {tuple(x.shape)}: bit-equal bf16 {row['bit_equal_bf16']} s32 "
                  f"{row['bit_equal_s32']}; {row['ms_bf16']:.4f} ms (acc bf16), {row['ms_s32']:.4f} ms (s32), "
                  f"{row['device_ms']:.4f} ms device ({row['device_ms_by']}; torch.profiler "
                  f"{row['profiler_ms']:.4f} ms over {row['profiler_events']} events of 3 calls, queued CUDA "
                  f"events {row['queued_ms']:.4f} ms; {100 * row['share_of_bound']:.1f}% of the bound), "
                  f"{row['plain_ms']:.3f} ms plain, {row['library_ms']:.4f} ms _int_mm over im2col, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}), {row['tops']:.1f} TOPS, {row['sass_gmma']} "
                  f"GMMA lines; device ms by launch "
                  f"{ {k: round(v, 4) for k, v in row['launch_ms'].items()} } on {gpu}", flush=True)
            res[name] = row
        # ragged crops of the forward's LR input: tiles cut by the image's edge
        ragged = {}
        for n_i, rh, rw in INT8_RAGGED:
            xr = x8[n_i:n_i + 1, :rh, :rw].contiguous()
            for name, kern, plain, *_ in (specs[0], specs[1], specs[3]):
                for acc in ("bf16", "s32"):
                    same = bool(torch.equal(kern(xr, acc), plain(xr, acc)))
                    ragged[f"{name} {rh}x{rw} {acc}"] = same
                    if not same:
                        failures.append(f"{name} (acc {acc}) on a ragged {tuple(xr.shape)} input: not bit-equal")
        print(f"[chip_smoke] X1-X3 on the ragged crops {[f'{h}x{w}' for _, h, w in INT8_RAGGED]}, both "
              f"accumulators: bit-equal {all(ragged.values())} ({len(ragged)} cases)", flush=True)
    rows = []
    for name in ("light53_int8_xla", "light_int8_xla", "light53_int8_xla_dyn"):
        row = res[name]
        extra = {}
        if name == "light53_int8_xla":
            hr = res["light53_int8_xla_hr"]
            extra = {f"hr_{k}": v for k, v in hr.items()}
        rows.append({
            "name": name, "route": "cuda",
            "source": "image_enhance_keras_tpu_torch/csrc/" + ("int8_blocks.cu" if name == "light53_int8_xla_dyn"
                                                               else "int8_conv.cu"),
            "replaces": X_REPLACES[name], "launches": None, "max_abs_err": max(row["max_abs_err_bf16"],
                                                                               row["max_abs_err_s32"]),
            "tolerance": 0.0, "ms": row["ms_bf16"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": "torch._int_mm over an int8 im2col of the block's convs (s32 sums only)",
            **{k: v for k, v in row.items() if k not in ("plain_ms", "bound_ms", "bound_by", "library_ms")},
            "ragged_bit_equal": all(v for k, v in ragged.items() if k.startswith(name + " ")), **extra,
        })
    return rows


def _uncalibrated_phase(params, qp_static, img, plan, failures: list, rows: list, gpu: str) -> dict:
    """Phase 3a'': ``quantize_didbl_params`` without ``calib_x`` and
    ``apply_didbl_int8`` at full width on the 9 patches of the seeded image:
    K4 and K5 in their dynamic form (per-window scales), K3 for the x4.
    Launch counts (K4 18, K5 6, K3 1), the output bit-equal with the same
    forward on the plain dynamic blocks, PSNR of its uint8 output against
    the float32 forward's (``apply_didbl_pallas``, 30 dB or more, as 3a'),
    the time per forward beside the calibrated tree's, and bit-equality on
    one whole Set5 LR frame whose sides are not multiples of 8 (86x57: the
    8-pad and windows cut by the image's edge)."""
    import numpy as np
    import torch

    from image_enhance_keras_tpu_torch.eval.evaluate import degrade
    from image_enhance_keras_tpu_torch.data.io import imread
    from image_enhance_keras_tpu_torch.models import didbl_pallas
    from image_enhance_keras_tpu_torch.ops.cuda import int8_blocks as ki8
    from image_enhance_keras_tpu_torch.ops.cuda import upsample as kup
    from image_enhance_keras_tpu_torch.tiling.tiles import extract_tiles, pad_to_plan

    def plain53(x, *a, res_scale=0.1, identity_scale=0.9, tile=(64, 128), act_scales=None):
        assert act_scales is None
        return ki8.light53_int8_dynamic_plain(x, *a, tile, res_scale, identity_scale)

    def plain_light(x, *a, res_scale=0.1, tile=(64, 128), act_scales=None):
        assert act_scales is None
        return ki8.light_int8_dynamic_plain(x, *a, tile, res_scale)

    def forward(qp, x, plain=False):
        if plain:
            didbl_pallas.light53_int8, didbl_pallas.light_int8 = plain53, plain_light
        try:
            return didbl_pallas.apply_didbl_int8(qp, x)
        finally:
            didbl_pallas.light53_int8, didbl_pallas.light_int8 = ki8.light53_int8, ki8.light_int8

    def u8(t):
        return np.round(t.clamp(0.0, 1.0).float().cpu().numpy() * 255.0).astype(np.uint8)

    out: dict = {}
    with torch.inference_mode():
        dev = torch.device("cuda")
        tiles = extract_tiles(pad_to_plan(torch.from_numpy(img).to(dev).float(), plan), plan) / 255.0
        qd = didbl_pallas.quantize_didbl_params(params)
        with_act = [k for k, v in qd.items() if isinstance(v, dict) and "act" in v]
        if with_act:
            failures.append(f"uncalibrated tree has activation scales in {with_act}")
        ki8.light53_int8.launches = 0
        ki8.light_int8.launches = 0
        kup.upsample_phase_tf1_kernel.launches = 0
        torch.cuda.synchronize()
        got = forward(qd, tiles)
        torch.cuda.synchronize()
        launches = {"light53_int8": ki8.light53_int8.launches, "light_int8": ki8.light_int8.launches,
                    "upsample_phase_tf1": kup.upsample_phase_tf1_kernel.launches}
        want_l = {"light53_int8": 18, "light_int8": 6, "upsample_phase_tf1": 1}
        for row in rows:
            if row["name"] in ("light53_int8_dynamic", "light_int8_dynamic"):
                row["launches"] = launches[row["name"].replace("_dynamic", "")]
        if launches != want_l:
            failures.append(f"uncalibrated int8 forward launches {launches} != {want_l}")
        ref = forward(qd, tiles, plain=True)
        same = bool(torch.equal(got, ref))
        if not same:
            failures.append(f"uncalibrated int8 forward: kernels not bit-equal to the plain blocks (max |diff| "
                            f"{(got - ref).abs().max().item():.3g})")
        if tuple(got.shape) != (9, 384, 384, 3) or not bool(torch.isfinite(got).all()):
            failures.append(f"uncalibrated int8 forward: shape {tuple(got.shape)} or non-finite values")
        f32 = didbl_pallas.apply_didbl_pallas(params, tiles)
        psnr = _psnr(u8(got), u8(f32))
        psnr_static = _psnr(u8(forward(qp_static, tiles)), u8(f32))
        if psnr < 30.0:
            failures.append(f"uncalibrated int8 output is far from the float32 output: PSNR {psnr:.2f} dB")
        ms = _time_ms(lambda: forward(qd, tiles), iters=5, warmup=1)
        ms_static = _time_ms(lambda: forward(qp_static, tiles), iters=5, warmup=1)
        # device time by kernel and idle share of the uncalibrated forward
        from torch.profiler import ProfilerActivity, profile

        from image_enhance_keras_tpu_torch.utils.profiling import device_kernel_times

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.time()
            for _ in range(3):
                forward(qd, tiles)
            torch.cuda.synchronize()
            wall = (time.time() - t1) / 3
        prof_rows = device_kernel_times(prof)
        busy = sum(r[1] for r in prof_rows) / 3
        out["profile"] = {"wall_ms": wall * 1e3, "device_ms": busy,
                          "idle_share": max(0.0, 1.0 - busy / (wall * 1e3)),
                          "kernels": [(n[:90], ms_ / 3, calls // 3) for n, ms_, calls in prof_rows[:8]]}
        gt = imread(os.path.join(HERE, "data_set5", "woman_GT.png"))
        lr = torch.from_numpy(degrade(gt, 4, dev)).to(dev).float()[None] / 255.0
        frame_same = bool(torch.equal(forward(qd, lr), forward(qd, lr, plain=True)))
        if not frame_same:
            failures.append(f"uncalibrated int8 forward on the {tuple(lr.shape[1:3])} frame: kernels not "
                            f"bit-equal to the plain blocks")
    print(f"[chip_smoke] uncalibrated int8 forward (9 patches of 96x96): launches {launches}, bit-equal to "
          f"the plain dynamic blocks {same}, PSNR against float32 {psnr:.2f} dB (calibrated tree "
          f"{psnr_static:.2f} dB), {ms:.3f} ms a forward (calibrated tree {ms_static:.3f} ms) on {gpu}; "
          f"whole {tuple(lr.shape[1:3])} frame bit-equal {frame_same}", flush=True)
    pr = out["profile"]
    print(f"[chip_smoke] profile of the uncalibrated int8 forward: {pr['wall_ms']:.3f} ms wall, "
          f"{pr['device_ms']:.3f} ms device, idle share {pr['idle_share']:.3f} on {gpu}", flush=True)
    for name, ms_, calls in pr["kernels"]:
        print(f"[chip_smoke]   {ms_:9.3f} ms {calls:4d} calls  {name}", flush=True)
    out.update(launches=launches, bit_equal=same, psnr_vs_f32=psnr, psnr_static_vs_f32=psnr_static,
               ms_per_forward=ms, ms_per_forward_static=ms_static, frame=list(lr.shape[1:3]),
               frame_bit_equal=frame_same)
    return out


def _device_fields(device: list, bound_ms: float) -> dict:
    """A bf16 row's device times by queued CUDA events (kernel, cuDNN, kernel
    in turns): the kernel's mean of its two readings, cuDNN's, and the
    kernel's share of its bound."""
    kernel_ms = (device[0] + device[2]) / 2
    return {"device_ms": kernel_ms, "device_ms_readings": [device[0], device[2]], "library_device_ms": device[1],
            "bound_share": bound_ms / kernel_ms}


def _device_text(row: dict) -> str:
    return (f"device {row['device_ms']:.4f} ms ({row['device_ms_readings'][0]:.4f}; "
            f"{row['device_ms_readings'][1]:.4f}; queued CUDA events), {100 * row['bound_share']:.1f}% of the "
            f"bound, cuDNN bf16 {row['library_device_ms']:.4f} ms device")


def _device_check(row: dict, failures: list) -> None:
    """No device reading of a bf16 kernel is below its bound, and the Light53
    forms (K1, K6) are not slower than cuDNN's bf16 convs of the same blocks
    in the same run."""
    if row["name"].startswith("light53") and row["device_ms"] > row["library_device_ms"]:
        failures.append(f"{row['name']}: {row['device_ms']:.4f} ms device, slower than cuDNN bf16's "
                        f"{row['library_device_ms']:.4f} ms in the same run")
    if min(row["device_ms_readings"]) < row["bound_ms"]:
        failures.append(f"{row['name']}: a device reading {min(row['device_ms_readings']):.4f} ms below the bound "
                        f"{row['bound_ms']:.4f} ms")


def _bf16_kernels(params, tiles, failures: list, oihw, lib53, libl) -> list:
    """Phase 2 for the bf16 forms of K1, K2, K6 and K7 (``--dtype bfloat16``):
    each on the bf16 path's own inputs (the tiles cast to bf16, level1 in
    bf16, then 16 plain bf16 Light53 blocks for K2; K6's output for K7)
    against its plain bf16 version, also on the ragged crops; the full chains
    against the yardstick of summation order.  Returns the kernels' rows."""
    import torch

    from image_enhance_keras_tpu_torch.models.didbl_pallas import _conv, _stacked
    from image_enhance_keras_tpu_torch.ops.cuda import bf16
    from image_enhance_keras_tpu_torch.ops.cuda import blocks as kb
    from image_enhance_keras_tpu_torch.ops.cuda import tower as kt

    l53c, lc = ("conv_a1", "conv_a2", "conv_b1", "conv_b2"), ("conv_a", "conv_b")
    with torch.inference_mode():
        x53 = torch.relu(_conv(tiles.to(torch.bfloat16), params["level1"])).contiguous()
        h = x53
        for i in range(16):
            p = params[f"body53_{i}"]
            h = kb.light53_block_plain(h, *(p[c][k] for c in l53c for k in ("kernel", "bias")))
        xl = h.contiguous()
    n, hh, ww, c = (int(v) for v in x53.shape)
    print(f"[chip_smoke] bf16 block inputs {tuple(x53.shape)}: light53 max|x|={x53.float().abs().max().item():.4g}, "
          f"light max|x|={xl.float().abs().max().item():.4g}", flush=True)

    def bound(flops, x, args):
        nbytes = 2.0 * 2 * x.numel() + sum(2.0 * a.numel() if a.dim() >= 4 else 4.0 * a.numel() for a in args)
        return _bound(flops, PEAK_BF16_FLOPS, nbytes)

    def gaps(got, want, near_zero, max_ulps, what):
        frac, ulps = bf16.ulp_gaps(got, want, near_zero)
        err = (got.float() - want.float()).abs().max().item()
        print(f"[chip_smoke] {what}: {frac:.3g} of elements differ, largest gap {ulps:.3g} bf16 ulp, "
              f"max |d| {err:.3g} (bounds {BF16_FRAC}, {max_ulps:g} ulp)", flush=True)
        if not (frac <= BF16_FRAC and ulps <= max_ulps):
            failures.append(f"{what}: {frac:.3g} of elements differ, largest gap {ulps:.3g} bf16 ulp "
                            f"(bounds {BF16_FRAC}, {max_ulps:g} ulp)")
        return frac, ulps, err

    rows = []
    p53, pl = params["body53_0"], params["light_0"]
    a53 = [p53[cv][k] for cv in l53c for k in ("kernel", "bias")]
    al = [pl[cv][k] for cv in lc for k in ("kernel", "bias")]
    specs = [
        ("light53_block_bf16", kb.fused_light53_block, kb.light53_block_plain, lib53, x53, a53, 68,
         "image_enhance_keras_tpu/ops/pallas/blocks.py:181", "blocks.cu"),
        ("light_block_bf16", kb.fused_light_block, kb.light_block_plain, libl, xl, al, 18,
         "image_enhance_keras_tpu/ops/pallas/blocks.py:154", "blocks.cu"),
    ]
    with torch.inference_mode():
        for name, kern, plain, lib, x, args, taps, replaces, src in specs:
            got, want = kern(x, *args), plain(x, *args)
            torch.cuda.synchronize()
            frac, ulps, err = gaps(got, want, BF16_NEAR_ZERO, BF16_BLOCK_ULPS, f"{name} {tuple(x.shape)}")
            ragged = {}
            for n_i, rh, rw in F32_RAGGED:
                xr = x[n_i:n_i + 1, :rh, :rw].contiguous()
                ragged[f"{rh}x{rw}"] = gaps(kern(xr, *args), plain(xr, *args), BF16_NEAR_ZERO, BF16_BLOCK_ULPS,
                                            f"{name} ragged {tuple(xr.shape)}")[:2]
            ms = _time_ms(lambda: kern(x, *args))
            plain_ms = _time_ms(lambda: plain(x, *args))
            # the library: cuDNN's bf16 convolutions (float32 sums, one rounding
            # per conv), bf16 biases and combine
            xc = x.permute(0, 3, 1, 2)
            largs = [(oihw(a) if a.dim() == 4 else a).to(torch.bfloat16) for a in args]
            library_ms = _time_ms(lambda: lib(xc, *largs))
            # device ms a call without the host: kernel, cuDNN, kernel (queued CUDA events)
            device = [_queued_ms(lambda: kern(x, *args)), _queued_ms(lambda: lib(xc, *largs)),
                      _queued_ms(lambda: kern(x, *args))]
            flops = 2.0 * taps * c * c * n * hh * ww
            bound_ms, bound_by = bound(flops, x, args)
            rows.append({
                "name": name, "route": "cuda", "source": f"image_enhance_keras_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": None, "max_abs_err": err, "differing_share": frac,
                "max_gap_ulp": ulps, "tolerance": f"{BF16_FRAC} of elements, 1 bf16 ulp", "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                "library": "cuDNN bf16 F.conv2d of the same convs (rounds at other points)",
                "ragged": ragged, "dtype": "bfloat16", "tflops": flops / (ms * 1e-3) / 1e12,
                **_device_fields(device, bound_ms),
            })
            print(f"[chip_smoke] {name}: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain, {library_ms:.3f} ms "
                  f"cuDNN bf16 F.conv2d, bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{rows[-1]['tflops']:.2f} TFLOP/s; {_device_text(rows[-1])}", flush=True)
            _device_check(rows[-1], failures)

    # the chains: K = 1 under the single-block bound (the chain's near-zero
    # scale), then the path's 16 / 6 blocks against the yardstick
    s53 = _stacked([params[f"body53_{i}"] for i in range(16)], l53c)
    sl = _stacked([params[f"light_{i}"] for i in range(6)], lc)
    s53_1 = _stacked([params["body53_0"]], l53c)
    sl_1 = _stacked([params["light_0"]], lc)
    with torch.inference_mode():
        xc7 = kt.fused_light53_chain(x53, *s53).contiguous()

    def chained_lib(lib, k_blocks):
        def run(xc, *largs):
            for i in range(k_blocks):
                xc = lib(xc, *(a[i] for a in largs))
            return xc
        return run

    chain_specs = [
        ("light53_chain_bf16", kt.fused_light53_chain, kt.light53_chain_plain, kt.light53_chain_bf16,
         chained_lib(lib53, 16), x53, s53, s53_1, 16 * 68,
         "image_enhance_keras_tpu/ops/pallas/tower.py:166"),
        ("light_chain_bf16", kt.fused_light_chain, kt.light_chain_plain, kt.light_chain_bf16,
         chained_lib(libl, 6), xc7, sl, sl_1, 6 * 18,
         "image_enhance_keras_tpu/ops/pallas/tower.py:191"),
    ]
    with torch.inference_mode():
        for name, kern, plain, bf16_plain, lib, x, args, args1, taps, replaces in chain_specs:
            frac1, ulps1, _ = gaps(kern(x, *args1), plain(x, *args1), BF16_CHAIN_NEAR_ZERO, BF16_CHAIN_ULPS,
                                   f"{name} K=1")
            ragged = {}
            for n_i, rh, rw in F32_RAGGED:
                xr = x[n_i:n_i + 1, :rh, :rw].contiguous()
                ragged[f"{rh}x{rw}"] = gaps(kern(xr, *args1), plain(xr, *args1), BF16_CHAIN_NEAR_ZERO,
                                            BF16_CHAIN_ULPS, f"{name} K=1 ragged {tuple(xr.shape)}")[:2]
            got = kern(x, *args).float()
            p32 = plain(x, *args).float()
            p64 = bf16_plain(x, *args, sum_dtype=torch.float64).float()
            torch.cuda.synchronize()
            k_d, y_d = (got - p32).abs(), (p64 - p32).abs()
            stats = {"kernel_mean": k_d.mean().item(), "kernel_max": k_d.max().item(),
                     "yardstick_mean": y_d.mean().item(), "yardstick_max": y_d.max().item(),
                     "kernel_share": (k_d > 0).float().mean().item(),
                     "yardstick_share": (y_d > 0).float().mean().item(),
                     "kernel_vs_float64_mean": (got - p64).abs().mean().item()}
            print(f"[chip_smoke] {name} {tuple(x.shape)}: |kernel - plain| mean {stats['kernel_mean']:.3g} max "
                  f"{stats['kernel_max']:.3g} ({stats['kernel_share']:.3g} differ); yardstick |plain64 - plain| "
                  f"mean {stats['yardstick_mean']:.3g} max {stats['yardstick_max']:.3g} "
                  f"({stats['yardstick_share']:.3g} differ); |kernel - plain64| mean "
                  f"{stats['kernel_vs_float64_mean']:.3g} (bound {BF16_YARDSTICK_TIMES}x the yardstick)",
                  flush=True)
            if not (stats["kernel_mean"] <= BF16_YARDSTICK_TIMES * stats["yardstick_mean"]
                    and stats["kernel_max"] <= BF16_YARDSTICK_TIMES * stats["yardstick_max"]):
                failures.append(f"{name}: |kernel - plain| mean {stats['kernel_mean']:.3g} max "
                                f"{stats['kernel_max']:.3g} beyond {BF16_YARDSTICK_TIMES}x the yardstick "
                                f"(mean {stats['yardstick_mean']:.3g}, max {stats['yardstick_max']:.3g})")
            ms = _time_ms(lambda: kern(x, *args))
            plain_ms = _time_ms(lambda: plain(x, *args), iters=3, warmup=1)
            xc = x.permute(0, 3, 1, 2)
            largs = [(a.permute(0, 4, 3, 1, 2).contiguous() if a.dim() == 5 else a).to(torch.bfloat16)
                     for a in args]
            library_ms = _time_ms(lambda: lib(xc, *largs), iters=3, warmup=1)
            device = [_queued_ms(lambda: kern(x, *args), n=5), _queued_ms(lambda: lib(xc, *largs), n=5),
                      _queued_ms(lambda: kern(x, *args), n=5)]
            flops = 2.0 * taps * c * c * n * hh * ww
            bound_ms, bound_by = bound(flops, x, args)
            rows.append({
                "name": name, "route": "cuda", "source": "image_enhance_keras_tpu_torch/csrc/tower.cu",
                "replaces": replaces, "launches": None, "max_abs_err": stats["kernel_max"],
                "yardstick": stats, "k1_differing_share": frac1, "k1_max_gap_ulp": ulps1, "k1_ragged": ragged,
                "tolerance": f"{BF16_YARDSTICK_TIMES}x the float64-vs-float32 plain gap; K=1: "
                             f"{BF16_FRAC} of elements, {BF16_CHAIN_ULPS:g} bf16 ulp",
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms,
                "library": "cuDNN bf16 F.conv2d of the same convs, looped over the blocks (rounds at other points)",
                "dtype": "bfloat16", "tflops": flops / (ms * 1e-3) / 1e12,
                **_device_fields(device, bound_ms),
            })
            print(f"[chip_smoke] {name}: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain, {library_ms:.3f} ms "
                  f"cuDNN bf16 F.conv2d, bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{rows[-1]['tflops']:.2f} TFLOP/s; {_device_text(rows[-1])}", flush=True)
            _device_check(rows[-1], failures)
    return rows


def _bf16_cli(tmp: str, img, out_f32, failures: list, rows: list, outputs: dict) -> dict:
    """Phase 3a for ``--dtype bfloat16``: ``main_dirpath`` with ``--forward
    pallas`` (16 bf16 K1 and 6 bf16 K2 launches) and ``pallas_chain`` (one
    bf16 K6 and one bf16 K7 per chunk), K3 never (those paths' x4 is the
    dense contraction), each held against the same run with the plain bf16
    versions in place of the kernels, within BF16_YARDSTICK_TIMES the gap
    between the plain versions summed in float64 and in float32.  Sets the
    bf16 rows' launches; the kernels' outputs go into ``outputs`` by forward."""
    import functools

    import numpy as np
    import torch

    from image_enhance_keras_tpu_torch.cli import main_dirpath
    from image_enhance_keras_tpu_torch.data.io import imread, imwrite
    from image_enhance_keras_tpu_torch.models import didbl_pallas
    from image_enhance_keras_tpu_torch.ops.cuda import blocks as kb
    from image_enhance_keras_tpu_torch.ops.cuda import tower as kt
    from image_enhance_keras_tpu_torch.ops.cuda import upsample as kup

    counted = {"light53_block_bf16": kb.fused_light53_block, "light_block_bf16": kb.fused_light_block,
               "light53_chain_bf16": kt.fused_light53_chain, "light_chain_bf16": kt.fused_light_chain}
    bf16_plain = {"fused_light53_block": kb.light53_block_bf16, "fused_light_block": kb.light_block_bf16,
                  "fused_light53_chain": kt.light53_chain_bf16, "fused_light_chain": kt.light_chain_bf16}
    want = {"pallas": {"light53_block_bf16": 16, "light_block_bf16": 6, "light53_chain_bf16": 0,
                       "light_chain_bf16": 0, "upsample_phase_tf1": 0},
            "pallas_chain": {"light53_block_bf16": 0, "light_block_bf16": 0, "light53_chain_bf16": 1,
                             "light_chain_bf16": 1, "upsample_phase_tf1": 0}}
    out = {}
    for fwd in ("pallas", "pallas_chain"):
        outs = {}
        for variant in ("kernels", "plain", "plain64"):
            d = os.path.join(tmp, f"bf16_{fwd}_{variant}")
            os.makedirs(d)
            imwrite(os.path.join(d, "img.bmp"), img)
            for fn in (*counted.values(), kup.upsample_phase_tf1_kernel):
                fn.launches = 0
            for fn in counted.values():
                fn.bf16_launches = 0
            if variant != "kernels":
                sums = torch.float64 if variant == "plain64" else torch.float32
                for name, fn in bf16_plain.items():
                    setattr(didbl_pallas, name, functools.partial(fn, sum_dtype=sums))
            try:
                torch.cuda.synchronize()
                t1 = time.time()
                rc = main_dirpath.main([d, "--forward", fwd, "--dtype", "bfloat16"])
                torch.cuda.synchronize()
                cli_s = time.time() - t1
            finally:
                for name in bf16_plain:
                    setattr(didbl_pallas, name, getattr(kb if "block" in name else kt, name))
            launches = {k: fn.bf16_launches for k, fn in counted.items()}
            launches["upsample_phase_tf1"] = kup.upsample_phase_tf1_kernel.launches
            total = {k: fn.launches for k, fn in counted.items()}
            print(f"[chip_smoke] main_dirpath --dtype bfloat16 --forward {fwd} ({variant}): rc {rc}, "
                  f"{cli_s:.2f} s, bf16 launches {launches}", flush=True)
            expect = want[fwd] if variant == "kernels" else dict.fromkeys(want[fwd], 0)
            if rc != 0:
                failures.append(f"main_dirpath --dtype bfloat16 --forward {fwd} ({variant}) returned {rc}")
            if launches != expect or total != {k: launches[k] for k in counted}:
                failures.append(f"bf16 {fwd} ({variant}) launches {launches} (all dtypes {total}) != {expect}")
            if variant == "kernels":
                for row in rows:
                    if row["name"] in counted and want[fwd][row["name"]]:
                        row["launches"] = launches[row["name"]]
            outs[variant] = imread(os.path.join(d, "img_scaled(1x).bmp"))
        got = outputs[fwd] = outs["kernels"]
        if got.shape != (512, 512, 3) or float(got.astype(np.float64).std()) < 1.0:
            failures.append(f"bf16 {fwd} output shape {got.shape} or flat")
            continue
        dmax, frac = _u8_agreement(got, outs["plain"])
        ymax, yfrac = _u8_agreement(outs["plain64"], outs["plain"])
        psnr = _psnr(got, out_f32)
        print(f"[chip_smoke] bf16 {fwd} uint8, kernels vs plain versions: max diff {dmax}, differing fraction "
              f"{frac:.3g}; yardstick, plain summed in float64 vs float32: max diff {ymax}, differing "
              f"fraction {yfrac:.3g} (bound {BF16_YARDSTICK_TIMES}x each); PSNR against the float32 pallas "
              f"output {psnr:.2f} dB", flush=True)
        if dmax > BF16_YARDSTICK_TIMES * ymax or frac > BF16_YARDSTICK_TIMES * yfrac:
            failures.append(f"bf16 {fwd} kernels vs plain outputs differ: max {dmax}, fraction {frac:.3g}, "
                            f"beyond {BF16_YARDSTICK_TIMES}x the yardstick (max {ymax}, fraction {yfrac:.3g})")
        out[fwd] = {"u8_max_diff_vs_plain": dmax, "u8_differing_vs_plain": frac,
                    "yardstick_u8_max_diff": ymax, "yardstick_u8_differing": yfrac, "psnr_vs_f32": psnr}
    return out


def _plain_int8_blocks():
    """The plain int8 blocks with the kernels' signatures, to swap in for K4 and K5."""
    from image_enhance_keras_tpu_torch.ops.cuda import int8_blocks as ki8

    def plain53(x, *a, res_scale=0.1, identity_scale=0.9, tile=None, act_scales=None):
        return ki8.light53_int8_plain(x, *a, act_scales, res_scale, identity_scale)

    def plain_light(x, *a, res_scale=0.1, tile=None, act_scales=None):
        return ki8.light_int8_plain(x, *a, act_scales, res_scale)

    return plain53, plain_light


#: the XLA int8 forms' wrappers in models/didbl_pallas.py and their plain versions (X1, X2, X3)
_XLA_FORMS = (("light53_int8_xla", "light53_int8_xla_plain"), ("light_int8_xla", "light_int8_xla_plain"),
              ("light53_int8_xla_dyn", "light53_int8_xla_dyn_plain"),
              ("light53_int8_xla_upq", "light53_int8_xla_upq_plain"))


class _Swapped:
    """Within the block: the x4 of the module and int8 forwards, and difv4's
    x2s ("plain_x4"), or the int8 forwards' blocks and X4 ("plain_blocks"),
    replaced by their plain versions; "kernels" swaps nothing."""

    def __init__(self, variant: str):
        self.variant = variant

    def __enter__(self):
        from image_enhance_keras_tpu_torch.models import didbl, didbl_pallas
        from image_enhance_keras_tpu_torch.ops.resize import upsample_phase_plain

        from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as kx

        from image_enhance_keras_tpu_torch.models import difv4, zoo_int8
        from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as kc

        if self.variant == "plain_x4":
            from image_enhance_keras_tpu_torch.ops.cuda import upsample as kup

            didbl.upsample_phase_tf1 = didbl_pallas.upsample_phase_tf1 = upsample_phase_plain
            didbl_pallas.upsample_quant_tf1 = kup.upsample_quant_plain
            difv4.upsample_phase_tf1 = zoo_int8.upsample_phase_tf1 = upsample_phase_plain
        elif self.variant == "plain_blocks":
            didbl_pallas.light53_int8, didbl_pallas.light_int8 = _plain_int8_blocks()
            for wrapper, plain in _XLA_FORMS:
                setattr(didbl_pallas, wrapper, getattr(kx, plain))
            didbl_pallas.int8_conv3 = kc.int8_conv3_plain
            didbl_pallas.int8_conv3_dyn = kc.int8_conv3_dyn_plain
            for form in X4_FORMS:
                setattr(zoo_int8, form, getattr(kc, f"{form}_plain"))
        return self

    def __exit__(self, *exc):
        from image_enhance_keras_tpu_torch.models import didbl, didbl_pallas
        from image_enhance_keras_tpu_torch.ops.cuda import int8_blocks as ki8
        from image_enhance_keras_tpu_torch.ops.resize import upsample_phase_tf1

        from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as kx

        from image_enhance_keras_tpu_torch.models import difv4, zoo_int8
        from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as kc

        from image_enhance_keras_tpu_torch.ops.cuda import upsample as kup

        didbl.upsample_phase_tf1 = didbl_pallas.upsample_phase_tf1 = upsample_phase_tf1
        didbl_pallas.upsample_quant_tf1 = kup.upsample_quant_tf1
        difv4.upsample_phase_tf1 = zoo_int8.upsample_phase_tf1 = upsample_phase_tf1
        didbl_pallas.light53_int8, didbl_pallas.light_int8 = ki8.light53_int8, ki8.light_int8
        for wrapper, _ in _XLA_FORMS:
            setattr(didbl_pallas, wrapper, getattr(kx, wrapper))
        didbl_pallas.int8_conv3 = kc.int8_conv3
        didbl_pallas.int8_conv3_dyn = kc.int8_conv3_dyn
        for form in X4_FORMS:
            setattr(zoo_int8, form, getattr(kc, form))
        return False


def _counted():
    """The counted wrappers: K3, K4, K5, K1, K2, K6, K7, X1, X2, X3, X4 (static, dynamic), K3q, X1u,
    X4's block forms (X4_FORMS)."""
    from image_enhance_keras_tpu_torch.ops.cuda import blocks as kb
    from image_enhance_keras_tpu_torch.ops.cuda import int8_blocks as ki8
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as kc
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as kx
    from image_enhance_keras_tpu_torch.ops.cuda import tower as kt
    from image_enhance_keras_tpu_torch.ops.cuda import upsample as kup

    return (kup.upsample_phase_tf1_kernel, ki8.light53_int8, ki8.light_int8, kb.fused_light53_block,
            kb.fused_light_block, kt.fused_light53_chain, kt.fused_light_chain, kx.light53_int8_xla,
            kx.light_int8_xla, kx.light53_int8_xla_dyn, kc.int8_conv3, kc.int8_conv3_dyn,
            kup.upsample_quant_tf1, kx.light53_int8_xla_upq, *(getattr(kc, f) for f in X4_FORMS))


def _counts() -> dict:
    """The nonzero launch counts of K3 (all and bf16), K4, K5, X1-X4 (X4's
    block forms by name), K3q, X1u, and of K1/K2 and K6/K7 on bf16 tensors."""
    k3, k4, k5, k1, k2, k6, k7, x1, x2, x3, x4, x4d, k3q, x1u, *forms = _counted()
    counts = {"upsample_phase_tf1": k3.launches, "upsample_phase_tf1_bf16": k3.bf16_launches,
              "light53_int8": k4.launches, "light_int8": k5.launches,
              "light53_block_bf16": k1.bf16_launches, "light_block_bf16": k2.bf16_launches,
              "light53_chain_bf16": k6.bf16_launches, "light_chain_bf16": k7.bf16_launches,
              "light53_int8_xla": x1.launches, "light_int8_xla": x2.launches,
              "light53_int8_xla_dyn": x3.launches, "int8_conv3": x4.launches, "int8_conv3_dyn": x4d.launches,
              "upsample_quant_tf1": k3q.launches, "light53_int8_xla_upq": x1u.launches,
              **{f: fn.launches for f, fn in zip(X4_FORMS, forms)}}
    return {k: v for k, v in counts.items() if v}


def _zero_counts() -> None:
    for fn in _counted():
        fn.launches = 0
        if hasattr(fn, "bf16_launches"):
            fn.bf16_launches = 0


def _mixed_cli(tmp: str, img, weights: str, out_bf16: dict, out8, failures: list) -> dict:
    """The mixed profiles through ``main_dirpath``.  On ``xla`` (patch mode,
    one forward for the 9 tiles): ``--dtype mixed`` launches the float32 K3
    once, ``mixed-tail`` the bf16 K3 once, each byte-equal to the same run
    with the plain x4.  ``--forward pallas`` / ``pallas_chain`` with
    ``--dtype mixed`` run the bf16 K1/K2 and K6/K7, byte-equal to the bf16
    runs; ``--forward pallas_int8 --dtype bfloat16`` is byte-equal to the
    float32 int8 run.  Then both mixed profiles in fast mode on a 20x24 crop,
    the card against the port on the CPU, within BF16_YARDSTICK_TIMES the
    gap between the CPU run summed in float64 and in float32."""
    import numpy as np
    import torch

    from image_enhance_keras_tpu_torch.cli import main_dirpath
    from image_enhance_keras_tpu_torch.data.io import imread, imwrite
    from image_enhance_keras_tpu_torch.engine import SuperResolver
    from image_enhance_keras_tpu_torch.models import blocks as mblocks

    def run(name, argv, variant="kernels"):
        d = os.path.join(tmp, name)
        os.makedirs(d)
        imwrite(os.path.join(d, "img.bmp"), img)
        _zero_counts()
        with _Swapped(variant):
            torch.cuda.synchronize()
            t1 = time.time()
            rc = main_dirpath.main([d, *argv])
            torch.cuda.synchronize()
        counts = _counts()
        print(f"[chip_smoke] main_dirpath {' '.join(argv)} ({variant}): rc {rc}, {time.time() - t1:.2f} s, "
              f"launches {counts}", flush=True)
        if rc != 0:
            failures.append(f"main_dirpath {' '.join(argv)} ({variant}) returned {rc}")
        return imread(os.path.join(d, "img_scaled(1x).bmp")), counts

    out: dict = {}
    k3 = {"mixed": {"upsample_phase_tf1": 1}, "mixed-tail": {"upsample_phase_tf1": 1, "upsample_phase_tf1_bf16": 1}}
    for profile in ("mixed", "mixed-tail"):
        argv = ["--forward", "xla", "--dtype", profile]
        got, counts = run(f"xla_{profile}", argv)
        plain, plain_counts = run(f"xla_{profile}_plain", argv, "plain_x4")
        same = bool(np.array_equal(got, plain))
        print(f"[chip_smoke] --dtype {profile} xla: byte-equal with the plain x4 {same}", flush=True)
        if counts != k3[profile] or plain_counts:
            failures.append(f"--dtype {profile} xla launches {counts} (plain x4 run {plain_counts}) "
                            f"!= {k3[profile]}")
        if not same or got.shape != (512, 512, 3) or float(got.astype(np.float64).std()) < 1.0:
            failures.append(f"--dtype {profile} xla: output {got.shape}, byte-equal with the plain x4 {same}")
        out[f"xla {profile}"] = {"launches": counts, "equal_plain_x4": same}
    want = {"pallas": {"light53_block_bf16": 16, "light_block_bf16": 6},
            "pallas_chain": {"light53_chain_bf16": 1, "light_chain_bf16": 1}}
    for fwd in ("pallas", "pallas_chain"):
        got, counts = run(f"{fwd}_mixed", ["--forward", fwd, "--dtype", "mixed"])
        same = fwd in out_bf16 and bool(np.array_equal(got, out_bf16[fwd]))
        print(f"[chip_smoke] --forward {fwd} --dtype mixed: byte-equal with --dtype bfloat16 {same}", flush=True)
        if counts != want[fwd] or not same:
            failures.append(f"--forward {fwd} --dtype mixed: launches {counts} (want {want[fwd]}), "
                            f"byte-equal with bf16 {same}")
        out[f"{fwd} mixed"] = {"launches": counts, "equal_bf16": same}
    got, counts = run("pallas_int8_bf16", ["--forward", "pallas_int8", "--dtype", "bfloat16"])
    same = bool(np.array_equal(got, out8))
    # K3 twice: calibration's x4 runs on float32 activations, the forward's on bf16
    want8 = {"upsample_phase_tf1": 2, "upsample_phase_tf1_bf16": 1, "light53_int8": 18, "light_int8": 6}
    print(f"[chip_smoke] --forward pallas_int8 --dtype bfloat16: byte-equal with float32 {same}", flush=True)
    if counts != want8 or not same:
        failures.append(f"--forward pallas_int8 --dtype bfloat16: launches {counts} (want {want8}), "
                        f"byte-equal with float32 {same}")
    out["pallas_int8 bfloat16"] = {"launches": counts, "equal_float32": same}

    crop = np.ascontiguousarray(img[:20, :24])
    conv = mblocks.conv2d_nhwc
    for profile, mixed in (("mixed", True), ("mixed-tail", "tail")):
        card = SuperResolver(weights=weights, mixed=mixed, mode="fast", device="cuda").upscale(crop)
        cpu_r = SuperResolver(weights=weights, mixed=mixed, mode="fast", device="cpu")
        cpu = cpu_r.upscale(crop)
        mblocks.conv2d_nhwc = lambda x, k, b=None: conv(x.double(), k.double(),
                                                        None if b is None else b.double()).to(x.dtype)
        try:
            cpu64 = cpu_r.upscale(crop)
        finally:
            mblocks.conv2d_nhwc = conv
        dmax, frac = _u8_agreement(card, cpu)
        ymax, yfrac = _u8_agreement(cpu64, cpu)
        print(f"[chip_smoke] --dtype {profile} fast 20x24 crop, card vs cpu: max diff {dmax}, differing "
              f"fraction {frac:.3g}; yardstick, cpu summed in float64 vs float32: max diff {ymax}, differing "
              f"fraction {yfrac:.3g} (bound {BF16_YARDSTICK_TIMES}x each)", flush=True)
        if dmax > BF16_YARDSTICK_TIMES * ymax or frac > BF16_YARDSTICK_TIMES * yfrac:
            failures.append(f"--dtype {profile} card vs CPU: max {dmax}, fraction {frac:.3g}, beyond "
                            f"{BF16_YARDSTICK_TIMES}x the yardstick (max {ymax}, fraction {yfrac:.3g})")
        out[f"cpu crop {profile}"] = {"u8_max_diff": dmax, "u8_differing": frac,
                                      "yardstick_u8_max_diff": ymax, "yardstick_u8_differing": yfrac}
    return out


def _int8_xla_cli(tmp: str, img, out_p, out_8, failures: list, rows: list) -> dict:
    """``main_dirpath --forward int8`` on the seeded 128x128 BMP (the engine's
    default calibration, the bundled photos): X1 18, X2 6, K3 twice (the
    calibration's float32 x4 and the forward's bf16 one), byte-equal with the
    plain x4 and with the plain X blocks in place of the kernels;
    ``--int8-emit s8`` byte-equal with wide; ``--int8-acc s32`` (the other
    accumulator form of the kernels) byte-equal with its plain blocks; PSNR
    against the float32 ``pallas`` output and the ``pallas_int8`` one."""
    import numpy as np
    import torch

    from image_enhance_keras_tpu_torch.cli import main_dirpath
    from image_enhance_keras_tpu_torch.data.io import imread, imwrite

    runs = {"kernels": ([], "kernels"), "plain_x4": ([], "plain_x4"), "plain_blocks": ([], "plain_blocks"),
            "emit_s8": (["--int8-emit", "s8"], "kernels"), "s32": (["--int8-acc", "s32"], "kernels"),
            "s32_plain_blocks": (["--int8-acc", "s32"], "plain_blocks")}
    x4 = {"upsample_phase_tf1": 2, "upsample_phase_tf1_bf16": 1}
    blocks = {"light53_int8_xla": 18, "light_int8_xla": 6}
    want = {"kernels": {**x4, **blocks}, "plain_x4": blocks, "plain_blocks": x4}
    outs, out = {}, {}
    for name, (extra, variant) in runs.items():
        d = os.path.join(tmp, f"int8_xla_{name}")
        os.makedirs(d)
        imwrite(os.path.join(d, "img.bmp"), img)
        _zero_counts()
        with _Swapped(variant):
            torch.cuda.synchronize()
            t1 = time.time()
            rc = main_dirpath.main([d, "--forward", "int8", *extra])
            torch.cuda.synchronize()
            secs = time.time() - t1
        counts = _counts()
        print(f"[chip_smoke] main_dirpath --forward int8 {' '.join(extra)} ({variant}): rc {rc}, {secs:.2f} s "
              f"(calibration included), launches {counts}", flush=True)
        if rc != 0:
            failures.append(f"main_dirpath --forward int8 {' '.join(extra)} ({variant}) returned {rc}")
        if counts != want[variant]:
            failures.append(f"--forward int8 {' '.join(extra)} ({variant}) launches {counts} != {want[variant]}")
        if name == "kernels":
            for row in rows:
                if row["name"] in counts:
                    row["launches"] = counts[row["name"]]
        outs[name] = imread(os.path.join(d, "img_scaled(1x).bmp"))
        out[name] = {"launches": counts, "s": secs}
    y = outs["kernels"]
    if y.shape != (512, 512, 3) or float(y.astype(np.float64).std()) < 1.0:
        failures.append(f"--forward int8 output {y.shape} or flat")
    for a, b in (("kernels", "plain_x4"), ("kernels", "plain_blocks"), ("kernels", "emit_s8"),
                 ("s32", "s32_plain_blocks")):
        same = bool(np.array_equal(outs[a], outs[b]))
        out[f"{b}_equal_{a}"] = same
        print(f"[chip_smoke] --forward int8: the {b} run byte-equal with the {a} run: {same}", flush=True)
        if not same:
            failures.append(f"--forward int8: {b} differs from {a}: {_u8_agreement(outs[a], outs[b])}")
    smax, sfrac = _u8_agreement(outs["s32"], y)
    out.update(psnr_vs_f32=_psnr(y, out_p), psnr_vs_pallas_int8=_psnr(y, out_8), s32_vs_bf16_max=smax,
               s32_vs_bf16_differing=sfrac)
    print(f"[chip_smoke] --forward int8 output: PSNR {out['psnr_vs_f32']:.2f} dB against the float32 pallas "
          f"output, {out['psnr_vs_pallas_int8']:.2f} dB against pallas_int8; --int8-acc s32 against bf16: max "
          f"{smax}, {sfrac:.3g} of the values differ", flush=True)
    if out["psnr_vs_f32"] < 30.0:
        failures.append(f"--forward int8 output is far from the float32 output: PSNR {out['psnr_vs_f32']:.2f} dB")
    return out


def _split_phase(weights: str, qp, failures: list, gpu: str) -> dict:
    """A seeded SPLIT_HW square image in fast mode, split mode with stripes of
    SPLIT_TILE body rows, and split mode on 2-D tiles of SPLIT2D_TILE (16
    tiles, two chunks of 8), on ``xla`` float32, ``xla`` bf16 (the bf16
    serving default) and ``pallas_int8`` (phase 2's quantized tree).  Each
    split run against fast on the same forward, each with the launches of K3
    (one per forward, stripe and chunk), K4 (16 on the body, 2 per stripe or
    chunk) and K5, and again with the plain x4 (and for int8 the plain
    blocks) in place of the kernels: byte-equal.  out-Mpix/s (best of two
    runs after a warm-up) and ``torch.cuda.max_memory_allocated`` per run."""
    import torch

    from image_enhance_keras_tpu_torch.engine import SuperResolver

    img = _seeded_image(SPLIT_HW, SPLIT_HW, SEED + 1)
    n_stripes = -(-SPLIT_HW // SPLIT_TILE)
    n_chunks = -(-(-(-SPLIT_HW // SPLIT2D_TILE)) ** 2 // 8)
    modes = {"fast": dict(mode="fast"), "split": dict(mode="split", split_tile=SPLIT_TILE),
             "split2d": dict(mode="split", split_tile=SPLIT2D_TILE, split_tile_w=SPLIT2D_TILE)}
    tails = {"fast": 1, "split": n_stripes, "split2d": n_chunks}
    # int8: the serving profile of the JAX CLI's epilog (--dtype bfloat16
    # --forward int8; the int8 forward ignores the dtype)
    forwards = {"xla": dict(forward="xla"), "xla bf16": dict(forward="xla", dtype=torch.bfloat16),
                "pallas_int8": dict(forward="pallas_int8"), "int8": dict(forward="int8", dtype=torch.bfloat16)}
    mpix = (4 * SPLIT_HW) ** 2 / 1e6
    out: dict = {}
    for fname, fkw in forwards.items():
        int8 = fname in ("pallas_int8", "int8")
        fast = None
        for mname, mkw in modes.items():
            r = SuperResolver(weights=weights, device="cuda", **fkw, **mkw)
            if int8:
                r._qparams = qp
            r.upscale(img)  # warm-up
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            secs = []
            for _ in range(2):
                torch.cuda.synchronize()
                t1 = time.time()
                y = r.upscale(img)
                torch.cuda.synchronize()
                secs.append(time.time() - t1)
            peak = torch.cuda.max_memory_allocated()
            counts = {k: v // 2 for k, v in _counts().items()}
            want = {"upsample_phase_tf1": tails[mname]}
            if fname != "xla":
                want["upsample_phase_tf1_bf16"] = tails[mname]
            if fname == "pallas_int8":
                want.update(light53_int8=16 + 2 * tails[mname], light_int8=6)
            elif fname == "int8":
                want.update(light53_int8_xla=16 + 2 * tails[mname], light_int8_xla=6)
            row = {"s": min(secs), "out_mpix_s": mpix / min(secs), "peak_mib": peak / 2**20,
                   "resident_mib": base / 2**20, "launches": counts}
            print(f"[chip_smoke] {fname} {mname} {SPLIT_HW}x{SPLIT_HW}: {min(secs):.4f} s, "
                  f"{row['out_mpix_s']:.3f} out-Mpix/s, peak {row['peak_mib']:.1f} MiB "
                  f"(resident before the run {row['resident_mib']:.1f}), launches {counts} on {gpu}", flush=True)
            if counts != want:
                failures.append(f"{fname} {mname} launches {counts} != {want}")
            if fast is None:
                fast = y
                if y.shape != (4 * SPLIT_HW, 4 * SPLIT_HW, 3) or float(y.std()) < 1.0:
                    failures.append(f"{fname} fast output {y.shape} or flat")
            else:
                dmax, frac = _u8_agreement(y, fast)
                # the int8 forward's split: the same exact sums and per-element float steps as fast
                bmax, bfrac = {"pallas_int8": (INT8_U8_MAX_DIFF, INT8_U8_MAX_FRAC), "int8": (0, 0.0)}.get(
                    fname, (U8_MAX_DIFF, U8_MAX_FRAC))
                print(f"[chip_smoke] {fname} {mname} vs fast: max diff {dmax}, differing fraction {frac:.3g} "
                      f"({int(round(frac * y.size))} values; bound {bmax} on {bfrac})", flush=True)
                row.update(u8_max_diff_vs_fast=dmax, u8_differing_vs_fast=frac)
                if dmax > bmax or frac > bfrac:
                    failures.append(f"{fname} {mname} vs fast: max {dmax}, fraction {frac:.3g}")
                for variant in ("plain_x4", "plain_blocks") if int8 else ("plain_x4",):
                    _zero_counts()
                    with _Swapped(variant):
                        yp = r.upscale(img)
                    same = bool((yp == y).all())
                    print(f"[chip_smoke] {fname} {mname} byte-equal with the {variant} run: {same}; "
                          f"its launches {_counts()}", flush=True)
                    row[f"equal_{variant}"] = same
                    if not same:
                        failures.append(f"{fname} {mname} differs from its {variant} run")
            out[f"{fname} {mname}"] = row
            del r
            torch.cuda.empty_cache()
        if fname == "int8":
            out.update(_int8_options(weights, qp, img, fast, failures, gpu))
    return out


def _int8_options(weights: str, qp, img, fast, failures: list, gpu: str) -> dict:
    """The int8 forward's engine options on the split phase's image, fast mode:
    ``int8_dynamic_tail`` (X3 twice, X1 16, X2 6) and ``int8_body_tile=256``
    (the body over 4 shifted tiles in segments of 4 blocks: X1 18, X2 6),
    each against its run with the plain X blocks (byte-equal); the tiled body
    also byte-equal with the untiled fast output ``fast``."""
    import torch

    from image_enhance_keras_tpu_torch.engine import SuperResolver

    out: dict = {}
    mpix = (4 * SPLIT_HW) ** 2 / 1e6
    cases = {"int8_dynamic_tail": ({"int8_dynamic_tail": True},
                                   {"light53_int8_xla": 16, "light_int8_xla": 6, "light53_int8_xla_dyn": 2}),
             "int8_body_tile=256": ({"int8_body_tile": 256},
                                    {"light53_int8_xla": 18, "light_int8_xla": 6})}
    for name, (attrs, want) in cases.items():
        r = SuperResolver(weights=weights, device="cuda", forward="int8", mode="fast")
        r._qparams = qp
        for k, v in attrs.items():
            setattr(r, k, v)
        r.upscale(img)  # warm-up
        _zero_counts()
        torch.cuda.synchronize()
        t1 = time.time()
        y = r.upscale(img)
        torch.cuda.synchronize()
        secs = time.time() - t1
        counts = {k: v for k, v in _counts().items() if not k.startswith("upsample")}
        _zero_counts()
        with _Swapped("plain_blocks"):
            yp = r.upscale(img)
        same_plain = bool((yp == y).all())
        row = {"s": secs, "out_mpix_s": mpix / secs, "launches": counts, "equal_plain_blocks": same_plain}
        print(f"[chip_smoke] int8 fast {SPLIT_HW}x{SPLIT_HW} {name}: {secs:.4f} s, {mpix / secs:.3f} out-Mpix/s, "
              f"launches {counts}; byte-equal with its plain-block run {same_plain} on {gpu}", flush=True)
        if counts != want or not same_plain:
            failures.append(f"int8 {name}: launches {counts} (want {want}), byte-equal with plain {same_plain}")
        if name.startswith("int8_body_tile"):
            row["equal_untiled"] = bool((y == fast).all())
            print(f"[chip_smoke] int8 {name} byte-equal with the untiled fast forward: {row['equal_untiled']}",
                  flush=True)
            if not row["equal_untiled"]:
                failures.append(f"int8 {name} differs from the untiled forward: {_u8_agreement(y, fast)}")
        else:
            dmax, frac = _u8_agreement(y, fast)
            row.update(u8_max_diff_vs_static=dmax, u8_differing_vs_static=frac)
            print(f"[chip_smoke] int8 {name} against the static tail: max {dmax}, {frac:.3g} of the values "
                  f"differ", flush=True)
        out[f"int8 {name}"] = row
        del r
        torch.cuda.empty_cache()
    return out


def _extras_phase(weights: str, img, failures: list) -> dict:
    """The x8 self-ensemble with 2 back-projection steps on a 48x48 crop at
    full width, fast mode, the card against the port on the CPU."""
    import numpy as np

    from image_enhance_keras_tpu_torch.engine import SuperResolver

    crop = np.ascontiguousarray(img[:48, 40:88])
    kw = dict(weights=weights, mode="fast", self_ensemble=True, back_projection=2)
    card = SuperResolver(device="cuda", **kw).upscale(crop)
    cpu = SuperResolver(device="cpu", **kw).upscale(crop)
    plain = SuperResolver(weights=weights, mode="fast", device="cuda").upscale(crop)
    dmax, frac = _u8_agreement(card, cpu)
    _, pfrac = _u8_agreement(card, plain)
    print(f"[chip_smoke] self-ensemble + back-projection 2, 48x48 crop: card vs cpu max diff {dmax}, "
          f"differing fraction {frac:.3g} (bound {U8_MAX_DIFF} on {U8_MAX_FRAC}); {pfrac:.3g} of the values "
          f"differ from the plain forward's", flush=True)
    if card.shape != (192, 192, 3) or dmax > U8_MAX_DIFF or frac > U8_MAX_FRAC or pfrac == 0.0:
        failures.append(f"self-ensemble + back-projection: shape {card.shape}, card vs CPU max {dmax}, "
                        f"fraction {frac:.3g}; against the plain forward {pfrac:.3g}")
    return {"u8_max_diff_vs_cpu": dmax, "u8_differing_vs_cpu": frac, "u8_differing_vs_plain_forward": pfrac}


# -- the rest of the zoo (phase 5) --------------------------------------------

#: the zoo's models with committed demo checkpoints, through the main path
ZOO_MODELS = ("didbl_subpixel", "difv4", "difvdsr")
#: X4 replaces no TPU kernel: JAX runs these convs as XLA ops; "replaces"
#: names the JAX functions (_quant_c, _qconv_xla, _deqf; the dynamic form's
#: _quant_dyn_sample, _deq_dyn)
X4_REPLACES = "image_enhance_keras_tpu/models/didbl_pallas.py:321"
X4_DYN_REPLACES = "image_enhance_keras_tpu/models/didbl_pallas.py:466"
#: X4's block forms (ops/cuda/int8_conv.py), the blocks' convs and combines of
#: models/zoo_int8.py: _light_i8 (conv_a's codes, conv_b + combine) and
#: _diff_i8 (conv_a's and conv_c's codes, conv_b's t and codes of d, conv_d + combine)
X4_FORMS = ("int8_conv3_codes", "int8_conv3_light", "int8_conv3_diff_b", "int8_conv3_diff_d")
X4_FORM_REPLACES = {"int8_conv3_codes": "image_enhance_keras_tpu/models/zoo_int8.py:123",
                    "int8_conv3_light": "image_enhance_keras_tpu/models/zoo_int8.py:125",
                    "int8_conv3_diff_b": "image_enhance_keras_tpu/models/zoo_int8.py:243",
                    "int8_conv3_diff_d": "image_enhance_keras_tpu/models/zoo_int8.py:249"}
#: the Set5 images the int8 zoo rows are scored on (EVAL_ZOO_INT8_CPU.json,
#: the TPU's didbl_subpixel_int8_fast_2img): the first two
ZOO_INT8_IMAGES = 2


def _x4_rows(qps: dict, img, failures: list, sass_x4, gpu: str) -> tuple[list, dict]:
    """X4 at every shape of the zoo's int8 forwards on their own activations
    (patch mode's 9 tiles of the seeded 128x128 image; difvdsr's first chunk
    of 16 tiles of its x4 input): the block forms the zoo's blocks run on
    (X4_FORMS: conv_a's codes, a LightBlock's conv_b + combine, a DiffBlock's
    four convs), the float32 entry (the subpixel head; difv4's and difvdsr's
    first convs as before) and its dynamic form, under the bf16 and s32
    accumulators; each bit-equal to its plain version, with its time, device
    ms, plain time, ``torch._int_mm`` over an int8 im2col of the same conv,
    bound (operations against the bytes its inputs and outputs move) and GMMA
    lines.  And K3 at factor 2, C = 256, bf16 and float32, bit-equal, with
    its share of the byte bound."""
    import torch

    from image_enhance_keras_tpu_torch.models import didbl_pallas as dp
    from image_enhance_keras_tpu_torch.models import zoo_int8 as zi
    from image_enhance_keras_tpu_torch.ops.color import im2double
    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as kc
    from image_enhance_keras_tpu_torch.ops.cuda import upsample as kup
    from image_enhance_keras_tpu_torch.ops.resize import resize_pil_uint8, upsample_phase_plain
    from image_enhance_keras_tpu_torch.tiling.tiles import extract_tiles, pad_to_plan, plan_tiles

    dev = torch.device("cuda")
    plan = plan_tiles(128, 128, patch=96, step=64, scale=4, crop=8)
    acc0 = "bf16"

    def codes(x, p, s_in, s_out, act):
        return kc.int8_conv3_codes(x, p["qf"], p["sf"], p["bias"], s_in, s_out, acc=acc0, act=act)

    with torch.inference_mode():
        tiles = im2double(extract_tiles(pad_to_plan(torch.from_numpy(img).to(dev).float(), plan), plan))
        up = resize_pil_uint8(torch.from_numpy(img).to(dev), (512, 512))
        plan1 = plan_tiles(512, 512, patch=96, step=64, scale=1, crop=8)
        tiles1 = im2double(extract_tiles(pad_to_plan(up, plan1), plan1))[:16]
        q4, qd, qs = qps["difv4"], qps["difvdsr"], qps["didbl_subpixel"]
        h = torch.relu(dp._conv(tiles.to(torch.bfloat16), q4["level1"]))
        x_head = h
        for i in range(6):
            h = zi._light_i8(h, q4[f"head_{i}"], zi._DIFV4_LEAKY_HEAD)
        head_out = h
        h = x_mid = kup.upsample_phase_tf1_kernel(h, 2)
        for i in range(20):
            h = zi._light_i8(h, q4[f"mid_{i}"], None)
        x_tail = kup.upsample_phase_tf1_kernel(h + x_mid, 2)
        del h
        lb = {k: q4[f"{k}_0"] for k in ("head", "mid", "tail")}
        tq = {"head": codes(x_head, lb["head"]["conv_a"], lb["head"]["actc"]["x"], lb["head"]["actc"]["t"],
                            zi._DIFV4_LEAKY_HEAD),
              "mid": codes(x_mid, lb["mid"]["conv_a"], lb["mid"]["actc"]["x"], lb["mid"]["actc"]["t"], "relu"),
              "tail": codes(x_tail, lb["tail"]["conv_a"], lb["tail"]["actc"]["x"], lb["tail"]["actc"]["t"], "relu")}
        t_tail = kc.int8_conv3(x_tail, lb["tail"]["conv_a"]["qf"], lb["tail"]["conv_a"]["sf"],
                               lb["tail"]["conv_a"]["bias"], lb["tail"]["actc"]["x"], acc=acc0, act="relu")
        x_dsr = torch.relu(dp._conv(tiles1.to(torch.bfloat16), qd["level1"]))
        db, sd = qd["diff_0"], qd["diff_0"]["actc"]
        t1q = codes(x_dsr, db["conv_a"], sd["x"], sd["t1"], "relu")
        pb = db["conv_b"]
        t_dsr, dq = kc.int8_conv3_diff_b(t1q, pb["qf"], pb["sf"], pb["bias"], x_dsr, sd["d"], acc=acc0)
        u1q = codes(dq, db["conv_c"], None, sd["u1"], zi._DSR_LEAKY)
        d_dsr = t_dsr - x_dsr.float()
        x_sub = dp.apply_didbl_int8_xla_body(qs, tiles)

    def form(name, *args, **kw):
        """(wrapper, kernel(acc), plain(acc), conv input, weights, the input's codes, dynamic?, the
        activations it reads: the conv input, and the block input x and t of the combines)."""
        fn, plain = getattr(kc, name), getattr(kc, f"{name}_plain")
        x, w = args[0], args[1]
        reads = [x, *(a for a in args[2:] if torch.is_tensor(a) and a.dim() == 4)]
        return (name, (lambda acc: fn(*args, acc=acc, **kw)), (lambda acc: plain(*args, acc=acc, **kw)), x, w,
                (lambda: x) if x.dtype == torch.int8 else (lambda: torch.clamp(
                    torch.round(x.float() * (1.0 / args[4])), -127.0, 127.0)), False, reads)

    def static(x, p, s_in, act):
        return form("int8_conv3", x, p["qf"], p["sf"], p["bias"], s_in, act=act)

    def dynamic(x, p):
        return ("int8_conv3_dyn", (lambda acc: kc.int8_conv3_dyn(x, p["q"], p["s"], p["bias"], acc=acc)),
                (lambda acc: kc.int8_conv3_dyn_plain(x, p["q"], p["s"], p["bias"], acc=acc)), x, p["q"],
                lambda: kc._quant_dyn_sample(x.float())[0], True, [x])

    def w(p):
        return p["qf"], p["sf"], p["bias"]

    sub = qs["subpixel_conv"]
    lk = zi._DIFV4_LEAKY_HEAD
    specs = [  # name, (wrapper, kernel(acc), plain(acc), x, weights, x's codes, dynamic?, activations read)
        ("difv4 head 256->256 LR conv_a codes, leaky",
         form("int8_conv3_codes", x_head, *w(lb["head"]["conv_a"]), lb["head"]["actc"]["x"], lb["head"]["actc"]["t"],
              act=lk)),
        ("difv4 head 256->256 LR conv_b + combine", form("int8_conv3_light", tq["head"], *w(lb["head"]["conv_b"]),
                                                         x_head)),
        ("difv4 mid 256->256 2x conv_a codes",
         form("int8_conv3_codes", x_mid, *w(lb["mid"]["conv_a"]), lb["mid"]["actc"]["x"], lb["mid"]["actc"]["t"],
              act="relu")),
        ("difv4 mid 256->256 2x conv_b + combine", form("int8_conv3_light", tq["mid"], *w(lb["mid"]["conv_b"]), x_mid)),
        ("difv4 tail 256->256 4x conv_a codes",
         form("int8_conv3_codes", x_tail, *w(lb["tail"]["conv_a"]), lb["tail"]["actc"]["x"], lb["tail"]["actc"]["t"],
              act="relu")),
        ("difv4 tail 256->256 4x conv_b + combine", form("int8_conv3_light", tq["tail"], *w(lb["tail"]["conv_b"]),
                                                         x_tail)),
        ("difvdsr 192->192 HR conv_a codes", form("int8_conv3_codes", x_dsr, *w(db["conv_a"]), sd["x"], sd["t1"],
                                                  act="relu")),
        ("difvdsr 192->192 HR conv_b t + codes of d", form("int8_conv3_diff_b", t1q, *w(db["conv_b"]), x_dsr, sd["d"])),
        ("difvdsr 192->192 HR conv_c codes -> codes, leaky",
         form("int8_conv3_codes", dq, *w(db["conv_c"]), None, sd["u1"], act=zi._DSR_LEAKY)),
        ("difvdsr 192->192 HR conv_d + combine", form("int8_conv3_diff_d", u1q, *w(db["conv_d"]), x_dsr, t_dsr)),
        ("difv4 head 256->256 LR float32 out, leaky", static(x_head, lb["head"]["conv_a"], lb["head"]["actc"]["x"], lk)),
        ("difv4 mid 256->256 2x float32 out", static(x_mid, lb["mid"]["conv_a"], lb["mid"]["actc"]["x"], "relu")),
        ("difv4 tail 256->256 4x float32 out", static(x_tail, lb["tail"]["conv_a"], lb["tail"]["actc"]["x"], "relu")),
        ("difv4 tail 256->256 4x, float32 x", static(t_tail, lb["tail"]["conv_b"], lb["tail"]["actc"]["t"], None)),
        ("difvdsr 192->192 HR float32 out", static(x_dsr, db["conv_a"], sd["x"], "relu")),
        ("difvdsr 192->192 HR, float32 x, leaky", static(d_dsr, db["conv_c"], sd["d"], zi._DSR_LEAKY)),
        ("didbl_subpixel head 128->2048 LR", static(x_sub, sub, sub["actc"]["x"], None)),
        ("didbl_subpixel head 128->2048 LR, dynamic", dynamic(x_sub, sub)),
    ]
    fns = (sass_x4 or {}).get("functions", {})
    src_tag = {torch.bfloat16: "13__nv_bfloat16", torch.float32: "f", torch.int8: "a"}

    def nbytes(v):
        return sum(nbytes(t) for t in v) if isinstance(v, (tuple, list)) else v.numel() * v.element_size()

    out = {}
    with torch.inference_mode():
        for name, (wrapper, kern, plain, x, wq, xcodes, dyn, reads) in specs:
            row = {"wrapper": wrapper, "shape": list(x.shape), "dtype": str(x.dtype)[6:], "c_out": int(wq.shape[-1])}
            for acc in ("bf16", "s32"):
                got, want = kern(acc), plain(acc)
                torch.cuda.synchronize()
                pairs = list(zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))))
                same = all(torch.equal(g, v) for g, v in pairs)
                d = max((g.float() - v.float()).abs().max().item() for g, v in pairs)
                row[f"bit_equal_{acc}"], row[f"max_abs_err_{acc}"] = same, d
                if not same:
                    failures.append(f"X4 {name} (acc {acc}): not bit-equal to its plain version (max |diff| {d:.3g})")
                out_bytes = nbytes(got)
                del got, want, pairs
            row["ms"] = _time_ms(lambda: kern("bf16"))
            row["ms_s32"] = _time_ms(lambda: kern("s32"))
            row["plain_ms"] = _time_ms(lambda: plain("bf16"), iters=1, warmup=1)
            pix, cin, cout = x[..., 0].numel(), int(x.shape[-1]), int(wq.shape[-1])
            ops = 2.0 * 9 * cin * cout * pix
            row["bytes"] = nbytes(reads) + out_bytes + wq.numel()
            row["bound_ms"], row["bound_by"] = _bound(ops, PEAK_INT8_OPS, row["bytes"])
            row["device_ms"], row["device_ms_by"] = _device_ms(lambda: kern("bf16"), row["bound_ms"], row)
            if row["device_ms"] < row["bound_ms"]:
                failures.append(f"X4 {name}: {row['device_ms']:.4f} ms device ({row['device_ms_by']}) is below "
                                f"its bound {row['bound_ms']:.4f} ms: the reading or the bound is wrong")
            row["library_ms"] = _time_ms(_int_mm_convs([(xcodes().to(torch.int8), wq)]), iters=3, warmup=1)
            row["tops"] = ops / (row["ms"] * 1e-3) / 1e12
            row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
            nt = 128 if cout % 128 == 0 else 96 if cout % 96 == 0 else 64
            mangled = f"conv3_kernelI{src_tag[x.dtype]}Lb{int(dyn)}ELi{nt}E"
            row["sass_gmma"] = sum(v for k, v in fns.items() if mangled in k)
            if row["sass_gmma"] == 0:
                failures.append(f"X4 {name}: no GMMA (wgmma) line in the SASS of its kernel function")
            print(f"[chip_smoke] X4 {name} {tuple(x.shape)} -> {cout}: bit-equal bf16 {row['bit_equal_bf16']} s32 "
                  f"{row['bit_equal_s32']}; {row['ms']:.4f} ms (acc bf16), {row['ms_s32']:.4f} ms (s32), "
                  f"{row['device_ms']:.4f} ms device ({row['device_ms_by']}; torch.profiler "
                  f"{row['profiler_ms']:.4f} ms over {row['profiler_events']} events of 3 calls, queued CUDA "
                  f"events {row['queued_ms']:.4f} ms), {row['plain_ms']:.3f} ms plain, "
                  f"{row['library_ms']:.4f} ms _int_mm over im2col, bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
                  f"{100 * row['share_of_bound']:.1f}% of it), {row['tops']:.1f} TOPS, {row['sass_gmma']} GMMA lines "
                  f"on {gpu}", flush=True)
            out[name] = row
        # K3 at factor 2, C = 256: the head tower's output, bf16 (the int8 forward) and float32 (xla)
        k3 = {}
        for dt in (torch.bfloat16, torch.float32):
            x = head_out.to(dt).contiguous()
            got, want = kup.upsample_phase_tf1_kernel(x, 2), upsample_phase_plain(x, 2)
            same = bool(torch.equal(got, want))
            if not same:
                failures.append(f"K3 factor 2 C=256 {dt}: not bit-equal to its plain version")
            ms = _time_ms(lambda: kup.upsample_phase_tf1_kernel(x, 2))
            nbytes = 5.0 * x.numel() * x.element_size()  # read once, write 4x
            bound = 1e3 * nbytes / PEAK_BYTES_S
            dms, dby = _device_ms(lambda: kup.upsample_phase_tf1_kernel(x, 2), bound)
            if dms < bound:
                failures.append(f"K3 factor 2 C=256 {dt}: {dms:.4f} ms device ({dby}) is below its byte bound "
                                f"{bound:.4f} ms")
            k3[str(dt)[6:]] = {"shape": list(x.shape), "bit_equal": same, "ms": ms, "device_ms": dms,
                               "device_ms_by": dby, "bound_ms": bound, "share_of_byte_bound": bound / dms,
                               "plain_ms": _time_ms(lambda: upsample_phase_plain(x, 2), iters=3, warmup=1)}
            print(f"[chip_smoke] K3 factor 2 {tuple(x.shape)} {str(dt)[6:]}: bit-equal {same}; {ms:.4f} ms, "
                  f"{dms:.4f} ms device ({dby}), byte bound {bound:.4f} ms ({100 * bound / dms:.1f}% of it) on {gpu}",
                  flush=True)
    # one line of the kernels JSON a wrapper: its main-path row, the largest error over its rows
    main_rows = {"int8_conv3": "didbl_subpixel head 128->2048 LR",
                 "int8_conv3_dyn": "didbl_subpixel head 128->2048 LR, dynamic",
                 "int8_conv3_codes": "difv4 mid 256->256 2x conv_a codes",
                 "int8_conv3_light": "difv4 mid 256->256 2x conv_b + combine",
                 "int8_conv3_diff_b": "difvdsr 192->192 HR conv_b t + codes of d",
                 "int8_conv3_diff_d": "difvdsr 192->192 HR conv_d + combine"}
    replaces = {"int8_conv3": X4_REPLACES, "int8_conv3_dyn": X4_DYN_REPLACES, **X4_FORM_REPLACES}
    rows = []
    for name, key in main_rows.items():
        row = out[key]
        mine = [r for r in out.values() if r["wrapper"] == name]
        rows.append({
            "name": name, "route": "cuda", "source": "image_enhance_keras_tpu_torch/csrc/int8_conv.cu",
            "replaces": replaces[name], "launches": None,
            "max_abs_err": max(max(r["max_abs_err_bf16"], r["max_abs_err_s32"]) for r in mine),
            "tolerance": 0.0, "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": "torch._int_mm over an int8 im2col of the same conv (s32 sums only)",
            "shape": row["shape"], "device_ms": row["device_ms"],
        })
    return rows, {"x4": out, "k3_factor2": k3}


def _dsr_chunks() -> int:
    """The chunks of 16 tiles difvdsr's patch mode runs on the seeded 128x128 image (its x4, 512x512)."""
    from image_enhance_keras_tpu_torch.tiling.tiles import plan_tiles

    return -(-plan_tiles(512, 512, patch=96, step=64, scale=1, crop=8).n_tiles // 16)


def _zoo_want(n_dsr_calls: int) -> dict:
    """Launches a forward of each zoo CLI run makes on patch mode's 128x128
    (one chunk of 9 tiles; difvdsr: its x4, 512x512, in n_dsr_calls chunks of
    16 tiles): K3 twice in difv4 (the float32 module, or the int8 forward's
    bf16 and, in calibration, float32 x2s), X4 on every int8 residual conv."""
    return {
        ("didbl_subpixel", "xla"): {},
        ("difv4", "xla"): {"upsample_phase_tf1": 2},
        ("difvdsr", "xla"): {},
        ("didbl_subpixel", "int8"): {"light53_int8_xla": 18, "light_int8_xla": 6, "int8_conv3": 1},
        ("difv4", "int8"): {"upsample_phase_tf1": 4, "upsample_phase_tf1_bf16": 2, "int8_conv3_codes": 32,
                            "int8_conv3_light": 32},
        ("difvdsr", "int8"): {"int8_conv3_codes": 64 * n_dsr_calls, "int8_conv3_diff_b": 32 * n_dsr_calls,
                              "int8_conv3_diff_d": 32 * n_dsr_calls},
    }


def _without(counts: dict, variant: str) -> dict:
    """The launches left when ``variant``'s kernels are swapped for their plain versions."""
    gone = {"plain_x4": ("upsample_phase_tf1", "upsample_phase_tf1_bf16"),
            "plain_blocks": ("int8_conv3", "int8_conv3_dyn", "light53_int8_xla", "light_int8_xla",
                             "light53_int8_xla_dyn", "light53_int8", "light_int8", *X4_FORMS)}.get(variant, ())
    return {k: v for k, v in counts.items() if k not in gone}


def _zoo_cli(tmp: str, img, failures: list, gpu: str) -> dict:
    """``main_dirpath --model M`` on the seeded 128x128 BMP with each model's
    committed demo checkpoint (patch mode, the CLI default): ``--forward xla``
    (float32) and ``--forward int8 --dtype bfloat16`` (the JAX CLI's serving
    profile), the counts zeroed just before each run and checked just after;
    the int8 runs again with the plain X4 (and X1/X2) and, for difv4, the
    plain x4 in place of the kernels, byte-equal; then the subpixel head's
    dynamic form (``int8_dynamic_tail``, fast mode), byte-equal with its plain
    blocks; the int8 output's PSNR against the float32 one."""
    import numpy as np
    import torch

    from image_enhance_keras_tpu_torch.cli import main_dirpath
    from image_enhance_keras_tpu_torch.data.io import imread, imwrite
    from image_enhance_keras_tpu_torch.engine import SuperResolver
    from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights

    want = _zoo_want(_dsr_chunks())
    out, outs = {}, {}
    for model in ZOO_MODELS:
        runs = [("xla", [], "kernels"), ("int8", ["--dtype", "bfloat16"], "kernels"),
                ("int8", ["--dtype", "bfloat16"], "plain_blocks")]
        if model == "difv4":
            runs.append(("int8", ["--dtype", "bfloat16"], "plain_x4"))
        for forward, extra, variant in runs:
            d = os.path.join(tmp, f"zoo_{model}_{forward}_{variant}")
            os.makedirs(d)
            imwrite(os.path.join(d, "img.bmp"), img)
            _zero_counts()
            with _Swapped(variant):
                torch.cuda.synchronize()
                t1 = time.time()
                rc = main_dirpath.main([d, "--model", model, "--forward", forward, *extra])
                torch.cuda.synchronize()
                secs = time.time() - t1
            counts = _counts()
            label = f"{model} --forward {forward} {' '.join(extra)} ({variant})"
            expect = _without(want[(model, forward)], variant)
            print(f"[chip_smoke] main_dirpath --model {label}: rc {rc}, {secs:.2f} s (calibration included), "
                  f"launches {counts} (want {expect}) on {gpu}", flush=True)
            if rc != 0:
                failures.append(f"main_dirpath --model {label} returned {rc}")
            if counts != expect:
                failures.append(f"main_dirpath --model {label}: launches {counts} != {expect}")
            outs[(model, forward, variant)] = imread(os.path.join(d, "img_scaled(1x).bmp"))
            out[label] = {"launches": counts, "s": secs}
        y, y8 = outs[(model, "xla", "kernels")], outs[(model, "int8", "kernels")]
        if y.shape != (512, 512, 3) or float(y.astype(np.float64).std()) < 1.0:
            failures.append(f"--model {model} output {y.shape} or flat")
        for variant in ("plain_blocks", "plain_x4"):
            if (model, "int8", variant) in outs:
                same = bool(np.array_equal(y8, outs[(model, "int8", variant)]))
                out[f"{model} int8 {variant} byte-equal"] = same
                print(f"[chip_smoke] --model {model} --forward int8: the {variant} run byte-equal: {same}",
                      flush=True)
                if not same:
                    failures.append(f"--model {model} --forward int8 with {variant} differs: "
                                    f"{_u8_agreement(y8, outs[(model, 'int8', variant)])}")
        psnr = _psnr(y8, y)
        out[f"{model} int8 psnr_vs_f32"] = psnr
        print(f"[chip_smoke] --model {model}: int8 output PSNR {psnr:.2f} dB against the float32 output", flush=True)
        if psnr < 30.0:
            failures.append(f"--model {model} --forward int8 output is far from float32: PSNR {psnr:.2f} dB")
    # the pallas forwards run the TF1 head only: refused on the subpixel head
    for forward in ("pallas", "pallas_chain", "pallas_int8"):
        try:
            SuperResolver(model="didbl_subpixel", forward=forward, device="cuda")
            failures.append(f"SuperResolver('didbl_subpixel', forward={forward!r}) did not raise")
        except ValueError as e:
            out[f"didbl_subpixel {forward} refused"] = str(e)
    # the subpixel head's dynamic form: int8_dynamic_tail (engine attribute; no CLI flag, as in JAX)
    weights = resolve_default_weights(MODEL_REGISTRY["didbl_subpixel"])
    dyn = {}
    for variant in ("kernels", "plain_blocks"):
        r = SuperResolver(model="didbl_subpixel", weights=weights, forward="int8", mode="fast", device="cuda")
        r.int8_dynamic_tail = True
        r._fwd_params()
        _zero_counts()
        with _Swapped(variant):
            dyn[variant] = r.upscale(img)
            torch.cuda.synchronize()
        counts = _counts()
        expect = _without({"light53_int8_xla": 16, "light_int8_xla": 6, "int8_conv3_dyn": 1,
                           "light53_int8_xla_dyn": 2}, variant)
        out[f"didbl_subpixel int8_dynamic_tail ({variant})"] = {"launches": counts}
        print(f"[chip_smoke] didbl_subpixel --forward int8 int8_dynamic_tail, fast ({variant}): launches {counts} "
              f"(want {expect})", flush=True)
        if counts != expect:
            failures.append(f"didbl_subpixel int8_dynamic_tail ({variant}): launches {counts} != {expect}")
    same = bool(np.array_equal(dyn["kernels"], dyn["plain_blocks"]))
    out["didbl_subpixel int8_dynamic_tail plain_blocks byte-equal"] = same
    if not same:
        failures.append(f"didbl_subpixel int8_dynamic_tail: plain blocks differ {_u8_agreement(*dyn.values())}")
    return out


class _CpuTorchOps:
    """Within the block: the pre-upscale's PIL resize and the bf16 convs of the
    int8 forwards (level1, out) computed on the CPU, as a CPU run computes
    them, for the forward on the card; everything else stays on the card."""

    def __enter__(self):
        import image_enhance_keras_tpu_torch.engine as eng
        from image_enhance_keras_tpu_torch.models import didbl_pallas
        from image_enhance_keras_tpu_torch.ops.conv import conv2d_nhwc
        from image_enhance_keras_tpu_torch.ops.resize import resize_pil_uint8

        def conv(x, k, b=None):
            return conv2d_nhwc(x.cpu(), k.cpu(), None if b is None else b.cpu()).to(x.device)

        eng.resize_pil_uint8 = lambda x, hw, *a: resize_pil_uint8(x.cpu(), hw, *a).to(x.device)
        didbl_pallas.conv2d_nhwc = conv
        return self

    def __exit__(self, *exc):
        import image_enhance_keras_tpu_torch.engine as eng
        from image_enhance_keras_tpu_torch.models import didbl_pallas
        from image_enhance_keras_tpu_torch.ops.conv import conv2d_nhwc
        from image_enhance_keras_tpu_torch.ops.resize import resize_pil_uint8

        eng.resize_pil_uint8, didbl_pallas.conv2d_nhwc = resize_pil_uint8, conv2d_nhwc
        return False


def _zoo_references(img, qps: dict, failures: list) -> dict:
    """Each model in fast mode on a 16x16 crop, on the card and on the CPU:
    float32 xla within 1 level on 0.1% of the values; int8 (the card's
    quantized tree on both) byte-equal when the card's run takes the
    pre-upscale and its bf16 level1 / out convs from the CPU (all else,
    X1-X4 and K3 included, must then give the CPU's bytes), and within
    INT8_U8_MAX_DIFF levels end to end, where cuDNN's bf16 convs round
    otherwise than the CPU's and the int8 codes carry a flip on through the
    blocks (a reading: difvdsr's 32 blocks at HR spread them widest)."""
    import numpy as np

    from image_enhance_keras_tpu_torch.engine import SuperResolver
    from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights

    crop = np.ascontiguousarray(img[:16, :16])
    out = {}
    for model in ZOO_MODELS:
        weights = resolve_default_weights(MODEL_REGISTRY[model])
        got = SuperResolver(model=model, weights=weights, mode="fast", device="cuda").upscale(crop)
        ref = SuperResolver(model=model, weights=weights, mode="fast", device="cpu").upscale(crop)
        dmax, frac = _u8_agreement(got, ref)
        r8 = {d: SuperResolver(model=model, weights=weights, mode="fast", forward="int8", device=d)
              for d in ("cuda", "cpu")}
        r8["cuda"]._qparams, r8["cpu"]._qparams = qps[model], _tree_to(qps[model], "cpu")
        cpu8 = r8["cpu"].upscale(crop)
        dmax8, frac8 = _u8_agreement(r8["cuda"].upscale(crop), cpu8)
        with _CpuTorchOps():
            hybrid = r8["cuda"].upscale(crop)
        same = bool(np.array_equal(hybrid, cpu8))
        out[model] = {"f32": (dmax, frac), "int8": (dmax8, frac8), "int8_cpu_torch_ops_byte_equal": same}
        print(f"[chip_smoke] --model {model} fast 16x16 crop, card vs cpu: float32 max diff {dmax} on {frac:.3g} "
              f"of the values; int8 (card's quantized tree) max diff {dmax8} on {frac8:.3g}, byte-equal with the "
              f"pre-upscale and bf16 convs from the CPU: {same}", flush=True)
        if dmax > U8_MAX_DIFF or frac > U8_MAX_FRAC:
            failures.append(f"--model {model} float32 card vs CPU differ: max {dmax}, fraction {frac:.3g}")
        if dmax8 > INT8_U8_MAX_DIFF or not same:
            failures.append(f"--model {model} int8 card vs CPU: max {dmax8} levels (bound {INT8_U8_MAX_DIFF}), "
                            f"byte-equal with the CPU's torch ops {same}")
    return out


def _zoo_set5(res8: dict, failures: list) -> dict:
    """Set5 x4 in fast mode through ``evaluate_model``: each model in float32
    against ``EVAL_ZOO.json`` (didbl_subpixel's row was scored on the CPU:
    float32 Y; difv4's and difvdsr's on the TPU they were trained on: the
    TPU's default-precision Y), and on the first two images against JAX's
    float32 rows on the CPU (``EVAL_ZOO_INT8_CPU.json``, float32 Y); the int8
    forwards (calibrated on the bundled photos) on the first two images
    against JAX's op-by-op int8 rows there, didbl_subpixel against the TPU's
    ``didbl_subpixel_int8_fast_2img`` on SSIM-Y, and each against the card's
    own float32 row of those images on SSIM-Y."""
    import glob

    from image_enhance_keras_tpu_torch.engine import SuperResolver
    from image_enhance_keras_tpu_torch.eval import evaluate_model
    from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights

    set5 = os.path.join(HERE, "data_set5")
    with open(os.path.join(HERE, "EVAL_ZOO.json")) as f:
        zoo_rows = json.load(f)
    with open(os.path.join(HERE, "EVAL_PROFILES.json")) as f:
        profiles = json.load(f)
    cpu_path = os.path.join(HERE, "EVAL_ZOO_INT8_CPU.json")
    cpu_rows = json.load(open(cpu_path)) if os.path.exists(cpu_path) else {}
    two = tempfile.mkdtemp(prefix="iek_chip_smoke_set5_2_")
    for p in sorted(glob.glob(os.path.join(set5, "*.png")))[:ZOO_INT8_IMAGES]:
        shutil.copy(p, two)
    out = {}

    def held(label, got, ref, db, ssim_tol, ssim_only=False):
        dp, ds = abs(got["psnr_y"] - ref["psnr_y"]), abs(got["ssim_y"] - ref["ssim_y"])
        ok = ds <= ssim_tol and (ssim_only or dp <= db)
        print(f"[chip_smoke] Set5 zoo {label}: {got['psnr_y']:.4f} / {got['ssim_y']:.5f} against "
              f"{ref['psnr_y']:.4f} / {ref['ssim_y']:.5f}: {'held' if ok else 'FAILED'}", flush=True)
        if not ok:
            failures.append(f"Set5 zoo {label}: {got['psnr_y']:.4f} / {got['ssim_y']:.5f} vs "
                            f"{ref['psnr_y']:.4f} / {ref['ssim_y']:.5f} (bounds {db} dB, {ssim_tol})")

    try:
        for model in ZOO_MODELS:
            weights = resolve_default_weights(MODEL_REGISTRY[model])
            r = SuperResolver(model=model, weights=weights, mode="fast", device="cuda")
            (_, exact), tpu = _scored(lambda: evaluate_model(r, set5, verbose=False))
            (_, exact2), _ = _scored(lambda: evaluate_model(r, two, verbose=False))
            (_, exact8), tpu8 = _scored(lambda: evaluate_model(res8[model], two, verbose=False))
            out[model] = {"f32": {"exact": exact, "tpu_default_y": tpu}, "f32_2img": exact2,
                          "int8_2img": {"exact": exact8, "tpu_default_y": tpu8}}
            ref = zoo_rows[model]
            cpu_scored = "CPU backend" in ref.get("provenance", "")
            held(f"{model} float32 (EVAL_ZOO.json, {'float32' if cpu_scored else 'TPU default-precision'} Y)",
                 exact if cpu_scored else tpu, ref, SET5_DB, SET5_SSIM)
            if model in cpu_rows:
                first = cpu_rows["images"][:ZOO_INT8_IMAGES]
                for label, got, row in (("float32", exact2, cpu_rows[model]["xla"]),
                                        ("int8", exact8, cpu_rows[model]["int8"])):
                    per = [row["per_image"][n]["exact"] for n in first]
                    ref2 = {"psnr_y": sum(p for p, _ in per) / len(per), "ssim_y": sum(q for _, q in per) / len(per)}
                    held(f"{model} {label}, {len(first)} images (JAX on the CPU{', op by op' if label == 'int8' else ''})",
                         got, ref2, SET5_DB, SET5_SSIM)
                if len(cpu_rows["images"]) == 5:
                    held(f"{model} float32, Set5 (JAX on the CPU)", exact, cpu_rows[model]["xla"]["exact"],
                         SET5_DB, SET5_SSIM)
            held(f"{model} int8, 2 images, SSIM-Y against the card's float32", exact8, exact2, 0.0, INT8_SSIM,
                 ssim_only=True)
            if model == "didbl_subpixel":
                held("didbl_subpixel int8, 2 images, SSIM-Y against the TPU's didbl_subpixel_int8_fast_2img", tpu8,
                     profiles["didbl_subpixel_int8_fast_2img"], 0.0, INT8_SSIM, ssim_only=True)
    finally:
        shutil.rmtree(two, ignore_errors=True)
    return out


def _zoo_phase(tmp: str, img, failures: list, rows: list, sass_x4, gpu: str) -> dict:
    """Phase 5: the rest of the zoo (didbl_subpixel, difv4, difvdsr) at full
    width with the committed demo checkpoints."""
    import torch

    from image_enhance_keras_tpu_torch.engine import SuperResolver
    from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights
    from image_enhance_keras_tpu_torch.utils.profiling import profile_upscale

    t0 = time.time()
    res8 = {}
    for model in ZOO_MODELS:  # the engine's calibration on the card (the bundled photos)
        res8[model] = SuperResolver(model=model, weights=resolve_default_weights(MODEL_REGISTRY[model]),
                                    forward="int8", mode="fast", device="cuda")
        res8[model]._fwd_params()
    qps = {m: r._qparams for m, r in res8.items()}
    x4_rows, kernels = _x4_rows(qps, img, failures, sass_x4, gpu)
    _phase("5a X4 and K3 at the zoo's shapes", t0)
    t0 = time.time()
    cli = _zoo_cli(tmp, img, failures, gpu)
    for row in x4_rows:  # the launches of the main paths' runs on the kernels
        row["launches"] = sum(v["launches"].get(row["name"], 0) for k, v in cli.items()
                              if isinstance(v, dict) and "(kernels)" in k)
    for row in x4_rows:
        if not row["launches"]:
            failures.append(f"{row['name']}: no launch on the zoo's main paths")
    rows.extend(x4_rows)
    _phase("5b the zoo's main paths (CLI)", t0)
    t0 = time.time()
    refs = _zoo_references(img, qps, failures)
    profiles = {}
    for model in ZOO_MODELS:
        weights = resolve_default_weights(MODEL_REGISTRY[model])
        for forward in ("xla", "int8"):
            r = SuperResolver(model=model, weights=weights, forward=forward, device="cuda")
            if forward == "int8":
                r._qparams = qps[model]
            iters = 3 if forward == "int8" else 1  # the float32 forwards take up to seconds an image
            wall, prof_rows = profile_upscale(r, img, iters)
            busy = sum(ms for _, ms, _ in prof_rows) / iters
            idle = max(0.0, 1.0 - busy / (wall * 1e3))
            # torch's elementwise kernels (casts, adds, products, copies) a forward launches: the float32
            # block combines of difv4 and difvdsr (4 or more a block in plain torch) live in X4's
            # epilogues, so what is left is the skip adds, the entry and out convs' activations,
            # casts and layout copies, fewer than one a block
            elementwise = sum(c for n, _, c in prof_rows if "elementwise" in n) // iters
            profiles[f"{model} {forward}"] = {"wall_ms": wall * 1e3, "device_ms": busy, "idle_share": idle,
                                              "elementwise_launches": elementwise,
                                              "kernels": [(n[:90], ms / iters, c // iters)
                                                          for n, ms, c in prof_rows[:8]]}
            print(f"[chip_smoke] profile --model {model} --forward {forward}, 128x128 patch mode: {wall * 1e3:.3f} ms "
                  f"wall, {busy:.3f} ms device, idle share {idle:.3f}, {elementwise} elementwise launches an "
                  f"image on {gpu}", flush=True)
            blocks = {"difv4": 32, "difvdsr": 32 * _dsr_chunks()}.get(model, 0)  # blocks run an image
            if forward == "int8" and blocks and elementwise >= blocks:
                failures.append(f"profile {model} int8: {elementwise} elementwise launches an image for {blocks} "
                                f"blocks: a block combine runs in plain torch")
            for name, ms, calls in profiles[f"{model} {forward}"]["kernels"]:
                print(f"[chip_smoke]   {ms:9.3f} ms {100 * ms / busy:5.1f}% {calls:4d} calls  {name}", flush=True)
            del r
            torch.cuda.empty_cache()
    _phase("5c the zoo on the card against the CPU, and profiles", t0)
    t0 = time.time()
    set5 = _zoo_set5(res8, failures)
    _phase("5d the zoo's Set5 rows", t0)
    return {"kernels": kernels, "cli": cli, "cpu_references": refs, "profiles": profiles, "set5": set5}


# -- training (phase 6) ----------------------------------------------------------

#: phase 6's fine-tune: steps per epoch of the full-width didbl (the CLI's
#: defaults: batch 10, --lr-patch 24, HR 96, float32, --monitor val_ssim_y)
TRAIN_STEPS = 3
#: the trainer's validation batches per epoch (Trainer.fit's val_steps)
TRAIN_VAL_STEPS = 4
#: internal-learning steps of phase 6 (main_dirpath --internal-learn)
IL_STEPS = 4
#: card against CPU, one narrow train step: the CPU tests' bounds
#: (tests/test_torch_train_step.py): loss rtol, gradient leaf gap over the
#: leaf's largest magnitude, params atol at lr 1e-4 where some step's
#: gradient is above G_FLOOR (below it Adam's eps dominates the update)
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL, TRAIN_PARAM_ATOL, TRAIN_G_FLOOR = 1e-5, 1e-4, 1e-6, 1e-6
TRAIN_NARROW = dict(features=16, n_body53=2, n_light=1, n_tail53=1)


def _k3_grad_rows(failures: list, gpu: str) -> list:
    """K3's gradient: the autograd of the kernel's op (``iek::upsample_phase_tf1``,
    whose backward is the autograd of the plain construction) against the
    plain construction's own autograd, bit for bit, at the training shapes
    (x4 at C = 128: the didbl train step's LR map; x2 at C = 256: difv4's),
    float32 and bf16, with the backward's time."""
    import torch

    from image_enhance_keras_tpu_torch.ops.cuda import upsample as kup
    from image_enhance_keras_tpu_torch.ops.resize import upsample_phase_plain

    out = []
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for f, shape in ((4, (10, 24, 24, 128)), (2, (10, 24, 24, 256))):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device="cuda").to(dt).requires_grad_(True)
            n, h, w, c = shape
            g = torch.randn((n, f * h, f * w, c), generator=gen, device="cuda").to(dt)
            (gk,) = torch.autograd.grad(kup.upsample_phase_tf1_kernel(x, f), x, g)
            (gp,) = torch.autograd.grad(upsample_phase_plain(x, f), x, g)
            torch.cuda.synchronize()
            equal = bool(torch.equal(gk, gp))
            z = torch.zeros(shape, dtype=dt, device="cuda", requires_grad=True)
            bwd = lambda: torch.autograd.grad(upsample_phase_plain(z, f), z, g)  # what the op's backward runs
            nbytes = x.numel() * x.element_size() * (1 + f * f)
            bound = nbytes / PEAK_BYTES_S * 1e3  # read g, write the gradient
            row = {"factor": f, "shape": list(shape), "dtype": str(dt).replace("torch.", ""), "bit_equal": equal,
                   "max_abs_err": float((gk.float() - gp.float()).abs().max()),
                   "backward_ms": _time_ms(bwd, iters=6, warmup=2), "backward_device_ms": _device_ms(bwd, bound)[0],
                   "forward_ms": _time_ms(lambda: kup.upsample_phase_tf1_kernel(x.detach(), f), iters=6, warmup=2),
                   "backward_bound_ms": bound}
            print(f"[chip_smoke] K3 gradient x{f} {row['dtype']} {tuple(shape)}: bit-equal to the plain "
                  f"autograd {equal}; plain backward {row['backward_ms']:.4f} ms per call "
                  f"({row['backward_device_ms']:.4f} device, byte bound {row['backward_bound_ms']:.4f}), "
                  f"K3 forward {row['forward_ms']:.4f} ms on {gpu}", flush=True)
            if not equal:
                failures.append(f"K3 gradient x{f} {row['dtype']}: the op's gradient differs from the plain "
                                f"autograd by {row['max_abs_err']}")
            out.append(row)
            del x, g, z, gk, gp
    return out


def _train_step_vs_plain_x4(params, batch, failures: list) -> dict:
    """One full-width train step on K3 and one with the plain x4 swapped in,
    from the same params and batch, cuDNN deterministic: the loss and every
    gradient leaf bit-equal."""
    import torch

    from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
    from image_enhance_keras_tpu_torch.models.weights import load_params
    from image_enhance_keras_tpu_torch.ops.cuda import upsample as kup
    from image_enhance_keras_tpu_torch.train.trainer import Adam, TrainState, make_train_step, mask_frozen

    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        res = {}
        for variant in ("kernels", "plain_x4"):
            module = DifvdsrDouble().to("cuda")
            load_params(module, params)
            state = TrainState(module, Adam(mask_frozen(module), 1e-4))
            before = kup.upsample_phase_tf1_kernel.launches
            with _Swapped(variant):
                state, m = make_train_step(4, 0.5)(state, batch)
            torch.cuda.synchronize()
            res[variant] = (m["loss"], {k: p.grad for k, p in state.opt.params.items()},
                            kup.upsample_phase_tf1_kernel.launches - before)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    (lk, gk, nk), (lp, gp, npl) = res["kernels"], res["plain_x4"]
    unequal = [k for k in gk if not torch.equal(gk[k], gp[k])]
    out = {"loss": float(lk), "loss_plain_x4": float(lp), "loss_bit_equal": bool(torch.equal(lk, lp)),
           "grad_leaves": len(gk), "grad_leaves_unequal": unequal, "k3_launches": [nk, npl]}
    print(f"[chip_smoke] train step on K3 vs the plain x4 (cuDNN deterministic): loss {float(lk)!r} vs "
          f"{float(lp)!r}, bit-equal {out['loss_bit_equal']}; {len(gk) - len(unequal)} of {len(gk)} gradient "
          f"leaves bit-equal; K3 launches {nk} / {npl}", flush=True)
    if not out["loss_bit_equal"] or unequal or (nk, npl) != (1, 0):
        failures.append(f"train step on K3 vs the plain x4: loss bit-equal {out['loss_bit_equal']}, unequal "
                        f"gradient leaves {unequal[:4]}, K3 launches {nk} / {npl} (want 1 / 0)")
    return out


def _train_card_vs_cpu(failures: list) -> dict:
    """The same narrow train step (seeded init and batch) on the card and on
    the CPU, within the CPU tests' bounds."""
    import numpy as np
    import torch

    from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
    from image_enhance_keras_tpu_torch.models.zoo import init_params
    from image_enhance_keras_tpu_torch.ops.cuda import upsample as kup
    from image_enhance_keras_tpu_torch.train.trainer import Adam, TrainState, make_train_step, mask_frozen

    batch = np.random.default_rng(SEED + 7).integers(0, 256, (2, 24, 24, 3), dtype=np.uint8)
    res = {}
    for dev in ("cpu", "cuda"):
        module = init_params(DifvdsrDouble(**TRAIN_NARROW), SEED + 7).to(dev)
        state = TrainState(module, Adam(mask_frozen(module), 1e-4))
        before = kup.upsample_phase_tf1_kernel.launches
        state, m = make_train_step(4, 0.5)(state, torch.from_numpy(batch).to(dev))
        res[dev] = (float(m["loss"]), {k: p.grad.cpu() for k, p in state.opt.params.items()},
                    {k: v.cpu() for k, v in state.params().items()}, kup.upsample_phase_tf1_kernel.launches - before)
    (lc, gc, pc, _), (lg, gg, pg, n3) = res["cpu"], res["cuda"]
    grad_rel = max(float((gg[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30) for k, g in gc.items())
    param_gap = max(float(torch.where(gc[k].abs() >= TRAIN_G_FLOOR, (pg[k] - v).abs(), 0.0).max())
                    for k, v in pc.items())
    out = {"loss_cpu": lc, "loss_card": lg, "loss_rel": abs(lg - lc) / abs(lc), "grad_rel": grad_rel,
           "param_gap": param_gap, "k3_launches": n3}
    print(f"[chip_smoke] narrow train step, card vs CPU: loss {lg!r} vs {lc!r} (rel {out['loss_rel']:.3g}, bound "
          f"{TRAIN_LOSS_RTOL}), gradient gap {grad_rel:.3g} of the leaf's largest (bound {TRAIN_GRAD_REL}), params "
          f"{param_gap:.3g} (bound {TRAIN_PARAM_ATOL}); K3 launches {n3}", flush=True)
    if out["loss_rel"] > TRAIN_LOSS_RTOL or grad_rel > TRAIN_GRAD_REL or param_gap > TRAIN_PARAM_ATOL or n3 != 1:
        failures.append(f"narrow train step, card vs CPU out of bounds: {out}")
    return out


def _train_timing(params, photos, val, gpu: str, dtype: str = "float32") -> dict:
    """Median ms per full-width train step (batch 10, HR 96, ``dtype``), HR
    patches/s, and a profile of 3 steps: device ms by kernel, idle share,
    peak device memory (and what was resident before the steps); then the
    optimizer's update alone, per call and in device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from image_enhance_keras_tpu_torch.train.trainer import Trainer
    from image_enhance_keras_tpu_torch.utils.config import Config
    from image_enhance_keras_tpu_torch.utils.profiling import device_kernel_times

    tmp = tempfile.mkdtemp(prefix="iek_chip_smoke_time_")
    try:
        t = Trainer(Config(model="didbl", dtype=dtype, checkpoint_dir=tmp, monitor="val_psnr"), photos, val,
                    params=params, device="cuda")
        batches = [t._batch(t.sampler.sample()) for _ in range(10)]
        for b in batches[:2]:
            t.train_step(t.state, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2 ** 20
        times = []
        for b in batches[2:7]:
            t0 = time.time()
            t.train_step(t.state, b)
            torch.cuda.synchronize()
            times.append((time.time() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for b in batches[7:10]:
                t.train_step(t.state, b)
            torch.cuda.synchronize()
            wall = (time.time() - t0) * 1e3 / 3
        opt_ms = _time_ms(t.state.opt.step, iters=6, warmup=1)
        opt_device_ms = _device_ms(t.state.opt.step)[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels = device_kernel_times(prof)
    busy = sum(ms for _, ms, _ in kernels) / 3
    groups = {"k3_forward": 0.0, "convs": 0.0, "other": 0.0}
    for name, ms, _ in kernels:
        low = name.lower()
        if "upsample_phase" in low:
            groups["k3_forward"] += ms / 3
        elif any(w in low for w in ("conv", "cudnn", "xmma", "gemm", "implicit", "wgrad", "dgrad", "fft", "winograd")):
            groups["convs"] += ms / 3
        else:
            groups["other"] += ms / 3
    ms = statistics.median(times)
    out = {"step_ms": ms, "step_ms_all": times, "hr_patches_per_s": 10 / (ms / 1e3), "profile_wall_ms": wall,
           "device_ms": busy, "idle_share": max(0.0, 1.0 - busy / wall), "peak_mib": peak,
           "resident_mib": resident, "optimizer_ms": opt_ms, "optimizer_device_ms": opt_device_ms,
           "device_ms_by_group": groups,
           "kernels": [(n[:90], k_ms / 3, c // 3) for n, k_ms, c in kernels[:12]]}
    print(f"[chip_smoke] train step, didbl full width, batch 10, HR 96, {dtype}: median {ms:.3f} ms "
          f"({out['hr_patches_per_s']:.1f} HR patches/s), profiled {wall:.3f} ms wall, {busy:.3f} ms device, idle "
          f"share {out['idle_share']:.3f}, peak {peak:.0f} MiB ({resident:.0f} resident before the steps); the "
          f"optimizer's update alone {opt_ms:.3f} ms per call, {opt_device_ms:.3f} ms device, on {gpu}", flush=True)
    print(f"[chip_smoke]   device ms per step by group: "
          f"{ {k: round(v, 3) for k, v in groups.items()} }", flush=True)
    for name, k_ms, calls in out["kernels"]:
        print(f"[chip_smoke]   {k_ms:9.3f} ms {100 * k_ms / busy:5.1f}% {calls:4d} calls  {name}", flush=True)
    return out


def _internal_learning(tmp: str, img, weights: str, failures: list, gpu: str) -> dict:
    """``main_dirpath --internal-learn`` under ``xla`` and ``int8`` on the
    128x128 image, launches counted against the same run without it; then,
    on an engine, the base module, params and int8 scales after the call, and
    the next image without adaptation against a fresh engine's bytes."""
    import numpy as np
    import torch

    from image_enhance_keras_tpu_torch.cli import main_dirpath
    from image_enhance_keras_tpu_torch.data.io import imread, imwrite
    from image_enhance_keras_tpu_torch.engine import SuperResolver

    out = {}
    for forward in ("xla", "int8"):
        runs = {}
        for il in (0, IL_STEPS):
            d = os.path.join(tmp, f"il_{forward}_{il}")
            os.makedirs(d)
            imwrite(os.path.join(d, "img.bmp"), img)
            _zero_counts()
            t0 = time.time()
            main_dirpath.main([d, "--forward", forward, "--internal-learn", str(il)])
            torch.cuda.synchronize()
            runs[il] = (time.time() - t0, _counts(), imread(os.path.join(d, "img_scaled(1x).bmp")))
        want = dict(runs[0][1])
        want["upsample_phase_tf1"] = want.get("upsample_phase_tf1", 0) + IL_STEPS
        r = SuperResolver(weights=weights, forward=forward, device="cuda")
        fresh = SuperResolver(weights=weights, forward=forward, device="cuda").upscale(img)
        r.upscale(img)  # the int8 scales of the base params
        m0, p0, q0 = r.module, r.params, r._qparams
        snap = {k: v.clone() for k, v in r.module.state_dict().items()}
        r.internal_learn = IL_STEPS
        adapted = r.upscale(img)
        restored = (r.module is m0 and r.params is p0 and r._qparams is q0
                    and all(torch.equal(v, snap[k]) for k, v in r.module.state_dict().items()))
        r.internal_learn = 0
        after = r.upscale(img)
        moved = _u8_agreement(adapted, fresh)
        out[forward] = {"cli_s": runs[IL_STEPS][0], "cli_s_without": runs[0][0], "launches": runs[IL_STEPS][1],
                        "launches_without": runs[0][1], "restored": restored,
                        "next_equals_fresh": bool(np.array_equal(after, fresh)),
                        "cli_shape": list(runs[IL_STEPS][2].shape), "adapted_vs_base": list(moved)}
        print(f"[chip_smoke] main_dirpath --forward {forward} --internal-learn {IL_STEPS}: {runs[IL_STEPS][0]:.2f} s "
              f"(without: {runs[0][0]:.2f} s), launches {runs[IL_STEPS][1]} (without {runs[0][1]}); base weights "
              f"and scales restored {restored}, next image equal to a fresh engine's "
              f"{out[forward]['next_equals_fresh']}; adapted vs base output: max {moved[0]} levels on "
              f"{moved[1]:.3g} of the values, on {gpu}", flush=True)
        if runs[IL_STEPS][1] != want or not restored or not out[forward]["next_equals_fresh"] \
                or runs[IL_STEPS][2].shape != (512, 512, 3):
            failures.append(f"--internal-learn under {forward}: launches {runs[IL_STEPS][1]} (want {want}), "
                            f"restored {restored}, next equal {out[forward]['next_equals_fresh']}")
        del r
    return out


def _train_phase(tmp: str, img, failures: list, rows: list, gpu: str) -> dict:
    """Phase 6: training.  A fine-tune of the full-width didbl from the demo
    checkpoint through ``cli.learn`` (2 epochs, then ``--resume`` for a
    third), K3 counted per step, the checkpoint served through
    ``main_dirpath``; the train step on K3 against the plain x4 and on the
    card against the CPU; K3's gradient against the plain autograd; a bf16
    train step; timing and a profile of the float32 step; internal learning."""
    import numpy as np
    import torch

    from image_enhance_keras_tpu_torch.cli import learn, main_dirpath
    from image_enhance_keras_tpu_torch.data.io import imread, imwrite
    from image_enhance_keras_tpu_torch.data.pipeline import PatchSampler, builtin_photos, load_image_dir
    from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights
    from image_enhance_keras_tpu_torch.train.checkpoints import export_params_npz, load_params_npz, restore_params, \
        save_params
    from image_enhance_keras_tpu_torch.train.trainer import Trainer
    from image_enhance_keras_tpu_torch.utils.config import Config

    out = {}
    t0 = time.time()
    weights = resolve_default_weights(MODEL_REGISTRY["didbl"])
    demo = load_params_npz(weights)
    set5 = os.path.join(HERE, "data_set5")
    photos, val = builtin_photos(), load_image_dir(set5)
    n_metric = sum(1 for im in val if (im.shape[0] // 4) * 4 >= 44 and (im.shape[1] // 4) * 4 >= 44)
    ck = os.path.join(tmp, "ck")
    # the demo weights as the state at step 0, so that learn --resume fine-tunes them
    seed = Trainer(Config(model="didbl", checkpoint_dir=ck), photos, val, params=demo, device="cuda")
    save_params(os.path.join(ck, "latest"), seed.state.state_dict())
    del seed
    common = ["--model", "didbl", "--builtin-photos", "--val-dir", set5, "--steps-per-epoch", str(TRAIN_STEPS),
              "--checkpoint-dir", ck, "--resume"]
    per_epoch = TRAIN_STEPS + TRAIN_VAL_STEPS + n_metric  # train, val and image-metric forwards
    fit = {}
    for epochs, n_ep in ((2, 2), (3, 1)):
        _zero_counts()
        t1 = time.time()
        learn.main([*common, "--epochs", str(epochs)])
        torch.cuda.synchronize()
        counts = _counts()
        index = json.load(open(os.path.join(ck, "index.json")))
        step = int(restore_params(os.path.join(ck, "latest"))["step"])
        fit[epochs] = {"s": time.time() - t1, "launches": counts, "epochs": [e["epoch"] for e in index["epochs"]],
                       "step": step}
        want = {"upsample_phase_tf1": n_ep * per_epoch}
        print(f"[chip_smoke] learn --epochs {epochs} --resume: {fit[epochs]['s']:.2f} s, K3 launches {counts} (want "
              f"{want}: {TRAIN_STEPS} train + {TRAIN_VAL_STEPS} val + {n_metric} image-metric forwards an epoch), "
              f"epochs {fit[epochs]['epochs']}, step {step}", flush=True)
        if counts != want or fit[epochs]["epochs"] != list(range(1, epochs + 1)) or step != epochs * TRAIN_STEPS:
            failures.append(f"learn --epochs {epochs}: launches {counts} (want {want}), epochs "
                            f"{fit[epochs]['epochs']}, step {step}")
    hist = json.load(open(os.path.join(ck, "history.json")))
    for i, e in enumerate(hist["epoch"]):
        print(f"[chip_smoke]   epoch {e}: loss {hist['loss'][i]:.6f} psnr {hist['psnr'][i]:.3f} val_psnr "
              f"{hist['val_psnr'][i]:.3f} val_psnr_y {hist['val_psnr_y'][i]:.3f} val_ssim_y "
              f"{hist['val_ssim_y'][i]:.5f} ({hist['sec'][i]:.2f} s)", flush=True)
    if not all(np.isfinite(hist[k]).all() for k in ("loss", "val_psnr", "val_psnr_y", "val_ssim_y")) \
            or min(hist["val_psnr_y"]) < 25.0:
        failures.append(f"fine-tune history not finite or val_psnr_y under 25 dB: {hist}")
    out["fit"], out["history"] = fit, hist
    # serve the fine-tuned checkpoint: its npz export and its latest/ directory, byte-equal
    state = restore_params(os.path.join(ck, "latest"))
    npz = os.path.join(tmp, "finetuned.npz")
    export_params_npz(npz, state["params"])
    served = {}
    for name, w in (("npz", npz), ("latest", os.path.join(ck, "latest")), ("demo", weights)):
        d = os.path.join(tmp, f"serve_{name}")
        os.makedirs(d)
        imwrite(os.path.join(d, "img.bmp"), img)
        main_dirpath.main([d, "--weights", w])
        served[name] = imread(os.path.join(d, "img_scaled(1x).bmp"))
    out["serve"] = {"npz_equals_latest": bool(np.array_equal(served["npz"], served["latest"])),
                    "psnr_vs_demo": _psnr(served["npz"], served["demo"]), "shape": list(served["npz"].shape)}
    print(f"[chip_smoke] main_dirpath on the fine-tuned npz: {out['serve']['shape']}, equal to serving latest/ "
          f"{out['serve']['npz_equals_latest']}, PSNR against the demo weights' output "
          f"{out['serve']['psnr_vs_demo']:.2f} dB", flush=True)
    if not out["serve"]["npz_equals_latest"] or served["npz"].shape != (512, 512, 3):
        failures.append(f"serving the fine-tuned checkpoint: {out['serve']}")
    _phase("6a fine-tune through learn, resume, serve", t0)

    t0 = time.time()
    batch = torch.from_numpy(PatchSampler(photos, hr_patch=96, batch_size=10, seed=SEED).sample()).to("cuda")
    out["k3_vs_plain_step"] = _train_step_vs_plain_x4(demo, batch, failures)
    out["k3_grad"] = _k3_grad_rows(failures, gpu)
    out["card_vs_cpu"] = _train_card_vs_cpu(failures)
    _phase("6b K3 against its plain version in the train step; card against CPU", t0)

    t0 = time.time()
    ck16 = os.path.join(tmp, "ck_bf16")
    _zero_counts()
    learn.main(["--model", "didbl", "--dtype", "bfloat16", "--builtin-photos", "--val-dir", set5, "--epochs", "1",
                "--steps-per-epoch", "2", "--monitor", "val_psnr", "--checkpoint-dir", ck16])
    torch.cuda.synchronize()
    counts16 = _counts()
    hist16 = json.load(open(os.path.join(ck16, "history.json")))
    want16 = {"upsample_phase_tf1": 2 + TRAIN_VAL_STEPS, "upsample_phase_tf1_bf16": 2 + TRAIN_VAL_STEPS}
    out["bf16"] = {"launches": counts16, "loss": hist16["loss"], "val_psnr": hist16["val_psnr"]}
    print(f"[chip_smoke] learn --dtype bfloat16 (1 epoch of 2 steps): loss {hist16['loss'][0]:.6f}, val_psnr "
          f"{hist16['val_psnr'][0]:.3f}, launches {counts16} (want {want16})", flush=True)
    if counts16 != want16 or not np.isfinite(hist16["loss"][0]):
        failures.append(f"bf16 train step: launches {counts16} (want {want16}), loss {hist16['loss']}")
    out["timing"] = _train_timing(demo, photos, val, gpu)
    out["timing_bf16"] = _train_timing(demo, photos, val, gpu, dtype="bfloat16")
    _phase("6c bf16 train step; timing and profile", t0)

    t0 = time.time()
    out["internal_learn"] = _internal_learning(tmp, img, weights, failures, gpu)
    _phase("6d internal learning (CLI)", t0)
    k3 = next(r for r in rows if r["name"] == "upsample_phase_tf1")
    k3["train_launches"] = {"per_train_step": 1, "fine_tune": fit[2]["launches"].get("upsample_phase_tf1", 0)
                            + fit[3]["launches"].get("upsample_phase_tf1", 0),
                            "bf16_step": counts16.get("upsample_phase_tf1_bf16", 0)}
    k3["train_backward"] = [{k: g[k] for k in ("factor", "dtype", "backward_ms", "backward_device_ms",
                                               "backward_bound_ms", "forward_ms")} for g in out["k3_grad"]]
    return out


# -- the serving runtime (phase 7) --------------------------------------------------

#: phase 7's directory: SERVE_N seeded SERVE_HW x SERVE_HW images and the Set5 LR images
SERVE_N, SERVE_HW = 8, 512
#: main_dirpath flags of phase 7's two profiles: the JAX CLI's serving profile over the whole
#: directory, and float32 xla patch over the Set5 LR images only (2.7 s of device time a
#: 512x512 image would take it far over the phase's budget)
SERVE_PROFILES = {"int8": ["--forward", "int8", "--dtype", "bfloat16", "--mode", "fast"],
                  "xla": ["--forward", "xla", "--dtype", "float32", "--mode", "patch"]}
#: the exported artifacts: export_model flags and the input size of each
EXPORTS = {"int8": (["--forward", "int8", "--mode", "fast", "--hw", "512", "512"], 512),
           "xla": (["--forward", "xla", "--dtype", "float32", "--mode", "patch", "--hw", "128", "128"], 128)}
#: what a subprocess runs on each artifact: load it with every plain version the
#: kernels' ops have made to raise, check the outputs and the launch counts, time it
_LOAD_CHECK = r'''
import json, statistics, sys, time
import numpy as np
import torch
from image_enhance_keras_tpu_torch.ops import resize
from image_enhance_keras_tpu_torch.ops.cuda import int8_xla, upsample
from image_enhance_keras_tpu_torch.runtime.export import load_forward

def refuse(*a, **k):
    raise RuntimeError("a plain version ran in the loaded program")

for name in ("light53_int8_xla_plain", "light_int8_xla_plain", "light53_int8_xla_dyn_plain"):
    setattr(int8_xla, name, refuse)
resize.upsample_phase_plain = refuse
counted = {"light53_int8_xla": int8_xla.light53_int8_xla, "light_int8_xla": int8_xla.light_int8_xla,
           "light53_int8_xla_dyn": int8_xla.light53_int8_xla_dyn, "upsample_phase_tf1": upsample.upsample_phase_tf1_kernel}
out = {}
for name, art, inp, want in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    fn = load_forward(art)
    load_ms = (time.perf_counter() - t0) * 1e3
    x = np.load(inp)
    for f in counted.values():
        f.launches = 0
    y = fn(x)
    launches = {k: f.launches for k, f in counted.items() if f.launches}
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn(x)
        times.append((time.perf_counter() - t0) * 1e3)
    nodes = {}
    for n in fn.program.graph.nodes:
        if n.op == "call_function" and getattr(n.target, "namespace", None) == "iek":
            k = n.target.name().split("::")[1].split(".")[0]
            nodes[k] = nodes.get(k, 0) + 1
    out[name] = {"equal": bool(np.array_equal(y, np.load(want))), "launches": launches, "iek_nodes": nodes,
                 "load_ms": load_ms, "ms": statistics.median(times)}
out["modules"] = sorted(m for m in sys.modules if m.startswith(
    ("image_enhance_keras_tpu_torch.models", "image_enhance_keras_tpu_torch.engine")))
print(json.dumps(out))
'''


def _codec_phase(failures: list) -> dict:
    """7a: build the native codec; decode ms per Set5 image by the native
    codec, PIL and the numpy decoder, and whether their decodes are equal."""
    import numpy as np

    from image_enhance_keras_tpu_torch.data import io as pio
    from image_enhance_keras_tpu_torch.runtime import native_io

    t0 = time.perf_counter()
    built = native_io.available()
    out = {"built": built, "build_s": time.perf_counter() - t0, "reason": native_io.unavailable_reason()}
    print(f"[chip_smoke] native codec (native/iek_io.cpp): built {built} in {out['build_s']:.2f} s"
          + ("" if built else f"; not available: {(out['reason'] or '')[-400:]}"), flush=True)
    decoders = {"numpy": pio._png_read}
    if built:
        decoders["native"] = native_io.imread
    pil = pio._pil()
    if pil is not None:
        decoders["PIL"] = lambda p: np.asarray(pil.open(p).convert("RGB"))
    files = pio.list_images(os.path.join(HERE, "data_set5"))
    decoded, out["decode_ms"] = {}, {}
    for name, dec in decoders.items():
        dec(files[0])
        t0 = time.perf_counter()
        decoded[name] = [dec(p) for p in files]
        out["decode_ms"][name] = (time.perf_counter() - t0) * 1e3 / len(files)
    out["equal"] = all(np.array_equal(a, b) for name in decoded for a, b in zip(decoded[name], decoded["numpy"]))
    print(f"[chip_smoke] Set5 decode ms per image: "
          f"{ {k: round(v, 3) for k, v in out['decode_ms'].items()} }; the decodes of "
          f"{sorted(decoded)} equal: {out['equal']}", flush=True)
    if not out["equal"]:
        failures.append(f"the codecs {sorted(decoded)} decode Set5 differently")
    return out


def _serve_dir(tmp: str) -> str:
    """SERVE_N seeded SERVE_HW^2 images and the Set5 LR images (PIL-bicubic /4
    of the GT, as scoring makes them), as PNG where a PNG writer is present
    (the native codec or PIL), else as BMP."""
    import numpy as np
    import torch

    from image_enhance_keras_tpu_torch.data import io as pio
    from image_enhance_keras_tpu_torch.ops.resize import resize_pil_uint8

    ext = ".png" if (pio._native() is not None or pio._pil() is not None) else ".bmp"
    d = os.path.join(tmp, "serve_base")
    os.makedirs(d)
    for i in range(SERVE_N):
        pio.imwrite(os.path.join(d, f"seeded_{i}{ext}"), _seeded_image(SERVE_HW, SERVE_HW, SEED + 70 + i))
    for p in pio.list_images(os.path.join(HERE, "data_set5")):
        hr = pio.imread(p)
        h, w = hr.shape[0] // 4 * 4, hr.shape[1] // 4 * 4
        lr = resize_pil_uint8(torch.from_numpy(np.array(hr[:h, :w])), (h // 4, w // 4))
        stem = os.path.splitext(os.path.basename(p))[0].replace("_GT", "")
        pio.imwrite(os.path.join(d, f"{stem}_LR{ext}"), lr.numpy().astype(np.uint8))
    return d


def _profiled(run):
    """``run()`` under ``torch.profiler``: (its result, wall s, device idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from image_enhance_keras_tpu_torch.utils.profiling import device_kernel_times

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(ms for _, ms, _ in device_kernel_times(prof)) / 1e3
    return out, wall, max(0.0, 1.0 - busy / wall)


def _pipeline_runs(tmp: str, base: str, failures: list, gpu: str) -> dict:
    """7b: ``main_dirpath`` serial and ``--pipeline`` over the same directory in
    each profile: outputs byte-equal, launches equal (int8: X1 18, X2 6, K3 1
    an image, and one float32 K3 of the calibration); from inside each run
    (``upscale_dir`` / ``serve_directory`` under ``torch.profiler``, the
    engine's set-up excluded) out-Mpix/s including IO and the device idle
    share, and ``PipelineStats``."""
    import numpy as np

    from image_enhance_keras_tpu_torch import engine
    from image_enhance_keras_tpu_torch.cli import main_dirpath
    from image_enhance_keras_tpu_torch.data.io import imread, list_images
    from image_enhance_keras_tpu_torch.runtime import serving

    timed: dict = {}
    serve, upscale_dir = serving.serve_directory, engine.SuperResolver.upscale_dir

    def timed_serve(*a, **k):
        st, timed["wall"], timed["idle"] = _profiled(lambda: serve(*a, **k))
        timed["stats"] = st
        return st

    def timed_dir(self, *a, **k):
        outs, timed["wall"], timed["idle"] = _profiled(lambda: upscale_dir(self, *a, **k))
        return outs

    res = {}
    for prof, flags in SERVE_PROFILES.items():
        src = base
        if prof == "xla":
            src = os.path.join(tmp, "serve_lr")
            os.makedirs(src)
            for n in os.listdir(base):
                if "_LR" in n:
                    shutil.copy(os.path.join(base, n), src)
        n_img = len(list_images(src))
        out_px = sum(int(np.prod(imread(p).shape[:2])) * 16 for p in list_images(src))
        runs = {}
        for name, extra in (("serial", []), ("pipeline", ["--pipeline"])):
            d = shutil.copytree(src, os.path.join(tmp, f"serve_{prof}_{name}"))
            _zero_counts()
            serving.serve_directory, engine.SuperResolver.upscale_dir = timed_serve, timed_dir
            try:
                rc = main_dirpath.main([d, *flags, *extra])
            finally:
                serving.serve_directory, engine.SuperResolver.upscale_dir = serve, upscale_dir
            files = {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d)) if "_scaled(1x)" in n}
            runs[name] = {"rc": rc, "launches": _counts(), "files": files, "wall": timed["wall"],
                          "idle": timed["idle"]}
            if rc != 0 or len(files) != n_img:
                failures.append(f"7b main_dirpath {' '.join(flags + extra)}: rc {rc}, {len(files)} of {n_img} outputs")
        st = timed["stats"]
        row = {"images": n_img, "out_mpix": out_px / 1e6, "launches": runs["serial"]["launches"],
               "serial_out_mpix_s": out_px / runs["serial"]["wall"] / 1e6, "serial_s": runs["serial"]["wall"],
               "pipeline": {"out_mpix_s": st.out_mpix_s, "wall_s": st.wall_s, "decode_s": st.decode_s,
                            "device_s": st.device_s, "encode_s": st.encode_s, "images": st.images},
               "idle_share": {"serial": runs["serial"]["idle"], "pipeline": runs["pipeline"]["idle"]},
               "bytes_equal": runs["serial"]["files"] == runs["pipeline"]["files"],
               "launches_equal": runs["serial"]["launches"] == runs["pipeline"]["launches"]}
        print(f"[chip_smoke] 7b {prof} ({' '.join(flags)}), {n_img} images, {row['out_mpix']:.3f} out-Mpix: serial "
              f"{row['serial_out_mpix_s']:.3f} out-Mpix/s incl. IO ({row['serial_s']:.3f} s, idle "
              f"{runs['serial']['idle']:.3f}); --pipeline {st.out_mpix_s:.3f} out-Mpix/s incl. IO (wall "
              f"{st.wall_s:.3f} s, decode {st.decode_s:.3f} s, device {st.device_s:.3f} s, encode {st.encode_s:.3f} s, "
              f"idle {runs['pipeline']['idle']:.3f}); outputs byte-equal {row['bytes_equal']}; launches "
              f"{runs['serial']['launches']} / {runs['pipeline']['launches']}; torch.profiler on; {gpu}", flush=True)
        if not row["bytes_equal"] or not row["launches_equal"] or st.images != n_img:
            failures.append(f"7b {prof}: --pipeline differs from the serial run (bytes equal {row['bytes_equal']}, "
                            f"launches {runs['serial']['launches']} / {runs['pipeline']['launches']})")
        if prof == "int8":
            want = {"light53_int8_xla": 18 * n_img, "light_int8_xla": 6 * n_img, "upsample_phase_tf1": n_img + 1,
                    "upsample_phase_tf1_bf16": n_img}
            if runs["serial"]["launches"] != want:
                failures.append(f"7b int8: launches {runs['serial']['launches']} != {want}")
        elif not runs["serial"]["launches"].get("upsample_phase_tf1"):
            failures.append(f"7b xla: K3 never launched ({runs['serial']['launches']})")
        res[prof] = row
    return res


def _intermediate_run(tmp: str, base: str, failures: list) -> dict:
    """7c: ``--save_intermediate`` on one Set5 LR image: the intermediate is
    ``resize_pil_uint8`` of the input at the output's size, byte for byte, and
    a second run over the directory skips it."""
    import numpy as np
    import torch

    from image_enhance_keras_tpu_torch.cli import main_dirpath
    from image_enhance_keras_tpu_torch.data.io import imread
    from image_enhance_keras_tpu_torch.ops.resize import resize_pil_uint8

    d = os.path.join(tmp, "intermediate")
    os.makedirs(d)
    src = next(n for n in sorted(os.listdir(base)) if n.startswith("bird_LR"))
    shutil.copy(os.path.join(base, src), d)
    stem, ext = os.path.splitext(src)
    argv = [d, *SERVE_PROFILES["int8"], "--save_intermediate"]
    rc = main_dirpath.main(argv)
    names = sorted(os.listdir(d))
    inter = os.path.join(d, f"{stem}_intermediate_{ext}")
    ok = rc == 0 and os.path.exists(inter)
    equal = False
    if ok:
        img, got = imread(os.path.join(d, src)), imread(inter)
        want = resize_pil_uint8(torch.from_numpy(img), got.shape[:2]).numpy().astype(np.uint8)
        equal = got.shape == (img.shape[0] * 4, img.shape[1] * 4, 3) and bool(np.array_equal(got, want))
    rc2 = main_dirpath.main(argv)
    skipped = rc2 == 0 and sorted(os.listdir(d)) == names
    print(f"[chip_smoke] 7c --save_intermediate: {names}; the intermediate equals resize_pil_uint8 of the input: "
          f"{equal}; a second run skips it: {skipped}", flush=True)
    if not (ok and equal and skipped):
        failures.append(f"7c --save_intermediate: written {ok}, equal {equal}, second run skips it {skipped}")
    return {"files": names, "equal": equal, "second_run_skips": skipped}


def _export_runs(tmp: str, img128, failures: list, gpu: str) -> dict:
    """7d: ``export_model`` of the int8 serving program (fast, 512x512) and of
    the float32 xla patch program (128x128); each loaded in one fresh
    subprocess that imports no model and no engine, with every plain version
    the ops could reach made to raise: byte-equal to ``resolver.upscale``, the
    kernels reached as ``iek::`` ops with their launch counts; MB, load ms and
    ms per image beside ``resolver.upscale``'s."""
    import statistics

    import numpy as np

    from image_enhance_keras_tpu_torch.cli import export_model
    from image_enhance_keras_tpu_torch.engine import SuperResolver
    from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights

    weights = resolve_default_weights(MODEL_REGISTRY["didbl"])
    images = {"int8": _seeded_image(512, 512, SEED + 80), "xla": img128}
    engines = {"int8": dict(dtype="bfloat16", forward="int8", mode="fast", split_tile=128),
               "xla": dict(forward="xla", mode="patch", split_tile=128)}
    want = {"int8": {"light53_int8_xla": 18, "light_int8_xla": 6, "upsample_phase_tf1": 1},
            "xla": {"upsample_phase_tf1": 1}}
    res, cases = {}, []
    for name, (flags, _) in EXPORTS.items():
        art = os.path.join(tmp, f"{name}.iekx")
        t0 = time.perf_counter()
        rc = export_model.main([art, *flags])
        export_s = time.perf_counter() - t0
        eng = SuperResolver(weights=weights, **engines[name])
        y = eng.upscale(images[name])
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.upscale(images[name])
            times.append((time.perf_counter() - t0) * 1e3)
        np.save(os.path.join(tmp, f"{name}_in.npy"), images[name])
        np.save(os.path.join(tmp, f"{name}_want.npy"), y)
        res[name] = {"rc": rc, "export_s": export_s, "mb": os.path.getsize(art) / 1e6,
                     "upscale_ms": statistics.median(times)}
        cases.append([name, art, os.path.join(tmp, f"{name}_in.npy"), os.path.join(tmp, f"{name}_want.npy")])
    proc = subprocess.run([sys.executable, "-c", _LOAD_CHECK, json.dumps(cases)], capture_output=True, text=True,
                          cwd=HERE, timeout=600)
    try:
        loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        failures.append(f"7d: the loading subprocess failed (rc {proc.returncode}): {proc.stderr[-2000:]}")
        return res
    for name in EXPORTS:
        r = {**res[name], **loaded[name]}
        res[name] = r
        print(f"[chip_smoke] 7d export_model {' '.join(EXPORTS[name][0])}: rc {r['rc']}, {r['mb']:.3f} MB in "
              f"{r['export_s']:.2f} s; loaded in a fresh process in {r['load_ms']:.1f} ms; byte-equal to "
              f"resolver.upscale {r['equal']}; launches {r['launches']}; iek:: nodes {r['iek_nodes']}; "
              f"{r['ms']:.3f} ms per image against resolver.upscale's {r['upscale_ms']:.3f}; {gpu}", flush=True)
        if r["rc"] != 0 or not r["equal"] or r["launches"] != want[name] or r["iek_nodes"] != want[name]:
            failures.append(f"7d {name} artifact: rc {r['rc']}, equal {r['equal']}, launches {r['launches']}, "
                            f"iek:: nodes {r['iek_nodes']} (want {want[name]})")
    res["modules_in_loader"] = loaded["modules"]
    if loaded["modules"]:
        failures.append(f"7d: loading the artifacts imported {loaded['modules']}")
    return res


def _front_door(tmp: str, base: str, failures: list) -> dict:
    """7e: ``python -m image_enhance_keras_tpu_torch upscale <dir> --forward int8`` exits 0."""
    d = os.path.join(tmp, "front_door")
    os.makedirs(d)
    src = next(n for n in sorted(os.listdir(base)) if n.startswith("head_LR"))
    shutil.copy(os.path.join(base, src), d)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "image_enhance_keras_tpu_torch", "upscale", d, "--forward", "int8"],
                          capture_output=True, text=True, cwd=HERE, timeout=600)
    secs = time.perf_counter() - t0
    wrote = sorted(n for n in os.listdir(d) if "_scaled(1x)" in n)
    print(f"[chip_smoke] 7e python -m image_enhance_keras_tpu_torch upscale <dir> --forward int8: rc "
          f"{proc.returncode} in {secs:.2f} s, wrote {wrote}", flush=True)
    if proc.returncode != 0 or not wrote:
        failures.append(f"7e: python -m image_enhance_keras_tpu_torch upscale: rc {proc.returncode}, "
                        f"{proc.stderr[-1500:]}")
    return {"rc": proc.returncode, "s": secs, "wrote": wrote}


def _serving_phase(tmp: str, img, failures: list, gpu: str) -> dict:
    """Phase 7: the serving runtime (the native codec, main_dirpath --pipeline
    and --save_intermediate, the exported artifacts, the python -m front door)."""
    t0 = time.time()
    out = {"codec": _codec_phase(failures)}
    base = _serve_dir(tmp)
    _phase("7a the native codec", t0)
    out["pipeline"] = _pipeline_runs(tmp, base, failures, gpu)
    _phase("7b main_dirpath --pipeline", t0)
    out["save_intermediate"] = _intermediate_run(tmp, base, failures)
    _phase("7c --save_intermediate", t0)
    out["export"] = _export_runs(tmp, img, failures, gpu)
    _phase("7d export_model and load_forward", t0)
    out["front_door"] = _front_door(tmp, base, failures)
    _phase("7e python -m image_enhance_keras_tpu_torch", t0)
    return out


# -- scale-out (phase 8) ----------------------------------------------------------

#: phase 8a's image side and the modes it shards: patch xla float32, fast and
#: split2d on the JAX CLI's serving profile (--forward int8 --dtype bfloat16,
#: split tiles 128/128), fast with int8_dynamic_tail (the per-sample abs-max
#: reduced over the bands), patch pallas_int8
SCALE_HW = 512
SCALE_RUNS = {
    "patch xla float32": dict(mode="patch", forward="xla"),
    "fast int8 bf16": dict(mode="fast", forward="int8", dtype="bfloat16"),
    "split2d int8 bf16": dict(mode="split", forward="int8", dtype="bfloat16", split_tile=128, split_tile_w=128),
    "fast int8 dynamic tail": dict(mode="fast", forward="int8", dtype="bfloat16", int8_dynamic_tail=True),
    "patch pallas_int8": dict(mode="patch", forward="pallas_int8"),
}
#: phase 8a's patch-average image side (compat's geometries: patch 32, step 4 and 16)
PATCH_AVG_HW = 96
#: phase 8b: the learn CLI's defaults (batch 10, HR 96), float32
DP_BATCH, DP_HR = 10, 96


def _scale_mesh():
    """Every card when there are two or more; else two entries of the one card."""
    import torch

    from image_enhance_keras_tpu_torch.parallel import make_mesh

    n = torch.cuda.device_count()
    return make_mesh(n) if n >= 2 else make_mesh(2, devices=["cuda:0", "cuda:0"])


def _timed_upscale(r, img) -> tuple:
    """(output, seconds) of one upscale after a warm-up, launches counted over the timed call."""
    import torch

    r.upscale(img)
    torch.cuda.synchronize()
    _zero_counts()
    t1 = time.time()
    y = r.upscale(img)
    torch.cuda.synchronize()
    return y, time.time() - t1, _counts()


def _banded_dyn_kernels(failures: list, gpu: str) -> dict:
    """Phase 8a: X3 and X4's dynamic form in steps over 3 bands of rows (the
    bands' abs-maxes reduced between the steps, ``parallel.bands.run_bands``)
    against one launch over the whole sample: bit-equal (torch.equal)."""
    import torch

    from image_enhance_keras_tpu_torch.ops.cuda import int8_conv as kc
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as kx
    from image_enhance_keras_tpu_torch.ops.cuda.int8_blocks import quantize_weights_per_channel
    from image_enhance_keras_tpu_torch.parallel.bands import Stage, Weights, run_bands, split_sizes

    gen = torch.Generator().manual_seed(SEED + 8)

    def conv(k, cin=128, cout=128):
        q, sc = quantize_weights_per_channel(torch.randn((k, k, cin, cout), generator=gen) * 0.05)
        return [q.cuda(), sc.cuda(), (torch.randn(cout, generator=gen) * 0.01).cuda()]

    x = (torch.randn((1, 192, 256, 128), generator=gen) * 2).to(torch.bfloat16).cuda()
    x3 = [*conv(3), *conv(5), *conv(5), *conv(3)]
    x4 = conv(3, 128, 256)
    checks = {
        "light53_int8_xla_dyn": (lambda t: kx.light53_int8_xla_dyn(t, *x3),
                                 Stage(lambda w, t, win: kx.light53_int8_xla_dyn_banded(t, win, *x3), 3, banded=True)),
        "int8_conv3_dyn": (lambda t: kc.int8_conv3_dyn(t, *x4, act="relu"),
                           Stage(lambda w, t, win: kc.int8_conv3_dyn_banded(t, win, *x4, act="relu"), 1,
                                 banded=True)),
    }
    out = {}
    for name, (whole, stage) in checks.items():
        want = whole(x)
        bands = list(torch.split(x, split_sizes(x.shape[1], 3), dim=1))
        got = torch.cat(run_bands([stage], bands, [Weights(None, None)] * 3), 1)
        torch.cuda.synchronize()
        out[name] = bool(torch.equal(got, want))
        print(f"[chip_smoke] 8a {name} over 3 bands of {tuple(x.shape)}, abs-maxes reduced between its steps, "
              f"bit-equal to one launch over the sample: {out[name]} on {gpu}", flush=True)
        if not out[name]:
            failures.append(f"8a banded {name} differs from its whole-sample launch")
    return out


def _sharded_inference(weights: str, mesh, failures: list, gpu: str) -> dict:
    """Phase 8a: each run of SCALE_RUNS through ShardedResolver against the
    single-device resolver on a seeded SCALE_HW square: byte-equal for patch,
    within one level for the banded modes (the count of differing values
    printed); out-Mpix/s and the launches by op of both."""
    import torch

    from image_enhance_keras_tpu_torch.engine import SuperResolver
    from image_enhance_keras_tpu_torch.parallel import ShardedResolver

    img = _seeded_image(SCALE_HW, SCALE_HW, SEED + 8)
    mpix = (4 * SCALE_HW) ** 2 / 1e6
    out = {}
    for name, kw in SCALE_RUNS.items():
        extra = {k: kw[k] for k in ("int8_dynamic_tail",) if k in kw}
        ctor = {k: v for k, v in kw.items() if k not in extra}
        one = SuperResolver(weights=weights, device="cuda", **ctor)
        many = ShardedResolver(weights=weights, mesh=mesh, **ctor)
        for r in (one, many):
            for k, v in extra.items():
                setattr(r, k, v)
        many._qparams = many._place_weights(one._fwd_params()) if one.forward_mode != "xla" else None
        y1, s1, c1 = _timed_upscale(one, img)
        yn, sn, cn = _timed_upscale(many, img)
        dmax, frac = _u8_agreement(yn, y1)
        n_diff = int(round(frac * y1.size))
        exact = name.startswith("patch")
        row = {"single_s": s1, "sharded_s": sn, "single_out_mpix_s": mpix / s1, "sharded_out_mpix_s": mpix / sn,
               "u8_max_diff": dmax, "differing_values": n_diff, "single_launches": c1, "sharded_launches": cn}
        print(f"[chip_smoke] 8a {name} {SCALE_HW}x{SCALE_HW} on {many.n_devices} mesh entries: single "
              f"{mpix / s1:.3f} out-Mpix/s, sharded {mpix / sn:.3f} out-Mpix/s; sharded vs single max diff {dmax}, "
              f"{n_diff} differing values (bound: {'byte-equal' if exact else 'one level'}); launches single {c1}, "
              f"sharded {cn} on {gpu}", flush=True)
        if yn.shape != (4 * SCALE_HW, 4 * SCALE_HW, 3) or float(yn.std()) < 1.0:
            failures.append(f"8a {name}: sharded output {yn.shape} or flat")
        if (exact and dmax) or dmax > 1:
            failures.append(f"8a {name}: sharded differs from single-device by up to {dmax} ({n_diff} values)")
        if not cn or set(cn) != set(c1):
            failures.append(f"8a {name}: sharded launches {cn} against single-device {c1}")
        out[name] = row
        del one, many
        torch.cuda.empty_cache()
    out["cudnn_batch_dependence"] = _cudnn_batch_dependence(weights, img, gpu)
    return out


def _sharded_patch_average(weights: str, mesh, failures: list, gpu: str) -> dict:
    """Phase 8a: ``ShardedResolver.upscale_patch_average`` against the
    single-device ``upscale_patch_average`` at ``compat``'s geometries (patch
    32 at step 4, its ``upscalePatch``, and at step 16, its legacy
    ``upscale``) on a seeded PATCH_AVG_HW square, float32 ``xla``: the uint8
    values that differ (held byte-equal: a batch-sharded mode)."""
    from image_enhance_keras_tpu_torch.engine import SuperResolver
    from image_enhance_keras_tpu_torch.parallel import ShardedResolver

    img = _seeded_image(PATCH_AVG_HW, PATCH_AVG_HW, SEED + 18)
    one = SuperResolver(weights=weights, device="cuda")
    many = ShardedResolver(weights=weights, mesh=mesh)
    out = {}
    for step in (4, 16):
        y1 = one.upscale_patch_average(img, patch=32, step=step)
        yn = many.upscale_patch_average(img, patch=32, step=step)
        dmax, frac = _u8_agreement(yn, y1)
        n_diff = int(round(frac * y1.size))
        n_tiles = ((PATCH_AVG_HW - 32) // step + 1) ** 2
        out[f"patch 32 step {step}"] = {"tiles": n_tiles, "u8_max_diff": dmax, "differing_values": n_diff}
        print(f"[chip_smoke] 8a patch-average patch 32 step {step} on {PATCH_AVG_HW}x{PATCH_AVG_HW} ({n_tiles} "
              f"tiles), float32 xla, {many.n_devices} mesh entries vs one device: {n_diff} uint8 values differ "
              f"(max {dmax}; bound byte-equal) on {gpu}", flush=True)
        if n_diff:
            failures.append(f"8a patch-average step {step}: sharded differs from single-device on {n_diff} values")
    return out


def _cudnn_batch_dependence(weights: str, img, gpu: str) -> dict:
    """Why the sharded patch engine keeps the single-device chunks whole (not
    held): the float32 ``xla`` forward of 8 tiles alone against the same 8
    tiles inside the batch of 16 the single-device engine runs."""
    import torch

    from image_enhance_keras_tpu_torch.engine import SuperResolver
    from image_enhance_keras_tpu_torch.ops.color import im2double
    from image_enhance_keras_tpu_torch.tiling.tiles import extract_tiles, pad_to_plan

    r = SuperResolver(weights=weights, device="cuda")
    plan = r.plan_for(*img.shape[:2])
    tiles = im2double(extract_tiles(pad_to_plan(torch.tensor(img, device="cuda").to(torch.float32), plan), plan))
    with torch.inference_mode():
        y16, y8 = r.module(tiles[:16])[:8], r.module(tiles[:8])
    u16, u8 = (r._finalize_u8(y * 255.0) for y in (y16, y8))
    out = {"max_abs_diff": float((y16 - y8).abs().max()), "u8_differing": int((u16 != u8).sum())}
    print(f"[chip_smoke] 8a the float32 xla forward of 8 tiles alone against the same 8 inside a batch of 16 "
          f"(cuDNN, TF32 off): max abs diff {out['max_abs_diff']:.3g}, {out['u8_differing']} uint8 values differ "
          f"on {gpu}", flush=True)
    return out


def _dp_step_check(mesh, failures: list, gpu: str) -> dict:
    """Phase 8b: one float32 data-parallel train step of the full-width didbl
    (demo weights, batch DP_BATCH of HR DP_HR patches of the bundled photos)
    on ``mesh`` against the single-device step: the loss within 1e-5
    (relative), the params within 1e-6 (elements whose gradient is under
    1e-6 within twice the lr: Adam divides by sqrt(nu) + 1e-8 there, so
    such an element moves by up to the lr, either way); ms per step of
    both."""
    import numpy as np
    import torch

    from image_enhance_keras_tpu_torch.data.pipeline import PatchSampler, builtin_photos
    from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights
    from image_enhance_keras_tpu_torch.train.checkpoints import load_params_npz
    from image_enhance_keras_tpu_torch.train.trainer import Trainer
    from image_enhance_keras_tpu_torch.utils.config import Config

    demo = load_params_npz(resolve_default_weights(MODEL_REGISTRY["didbl"]))
    batch = torch.from_numpy(PatchSampler(builtin_photos(), hr_patch=DP_HR, batch_size=DP_BATCH,
                                          seed=SEED).sample())
    tmp = tempfile.mkdtemp(prefix="iek_chip_smoke_dp_")
    res = {}
    try:
        for name, mesh_ in (("single", None), ("sharded", mesh)):
            t = Trainer(Config(model="didbl", checkpoint_dir=os.path.join(tmp, name), monitor="val_psnr"),
                        builtin_photos(), params=demo, device="cuda", mesh=mesh_)
            b = batch if mesh_ is not None else batch.to("cuda")
            _, m = t.train_step(t.state, b)
            grad = {k: p.grad.detach().clone() for k, p in t.state.opt.params.items()}
            torch.cuda.synchronize()
            params = {k: v.detach().clone() for k, v in t.state.params().items()}
            ms = []
            for _ in range(3):
                t1 = time.time()
                t.train_step(t.state, b)
                torch.cuda.synchronize()
                ms.append((time.time() - t1) * 1e3)
            res[name] = {"loss": float(m["loss"]), "params": params, "grad": grad, "ms": statistics.median(ms)}
            del t
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    one, many = res["single"], res["sharded"]
    dloss = abs(many["loss"] - one["loss"]) / abs(one["loss"])
    worst, worst_floor, worst_grad = 0.0, 0.0, 0.0
    for k, p in one["params"].items():
        d = (many["params"][k] - p).abs()
        g = one["grad"].get(k)
        floor = (g.abs() < 1e-6) if g is not None else torch.zeros_like(d, dtype=torch.bool)
        if g is not None:
            out_grad = float((many["grad"][k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
            worst_grad = max(worst_grad, out_grad)
        worst = max(worst, float(d[~floor].max()) if (~floor).any() else 0.0)
        worst_floor = max(worst_floor, float(d[floor].max()) if floor.any() else 0.0)
    out = {"loss_single": one["loss"], "loss_sharded": many["loss"], "loss_rel_diff": dloss,
           "param_max_diff": worst, "param_max_diff_small_grad": worst_floor, "grad_max_rel_diff": worst_grad,
           "single_ms": one["ms"],
           "sharded_ms": many["ms"], "mesh": [str(d) for d in mesh.local_devices()]}
    print(f"[chip_smoke] 8b DP train step (batch {DP_BATCH}, HR {DP_HR}, float32) over {out['mesh']}: loss "
          f"{many['loss']:.7f} against single-device {one['loss']:.7f} (relative {dloss:.3g}, bound 1e-5); params "
          f"max diff {worst:.3g} (bound 1e-6), {worst_floor:.3g} where |grad| < 1e-6 (bound 2e-4: each step "
          f"moves such an element by up to the lr, 1e-4, either way); "
          f"gradients within {worst_grad:.3g} of each leaf's largest; "
          f"{many['ms']:.2f} ms a step against {one['ms']:.2f} on {gpu}", flush=True)
    if not np.isfinite(many["loss"]) or dloss > 1e-5 or worst > 1e-6 or worst_floor > 2e-4:
        failures.append(f"8b DP step: loss diff {dloss:.3g}, params {worst:.3g} / {worst_floor:.3g}")
    return out


def _nccl_child(rank: int, world: int, out_path: str) -> int:
    """Phase 8c's child: one data-parallel step of the full-width didbl (demo
    weights, a batch of 2 seeded by the rank) on this rank's card, first
    without a process group (world 1), then after ``maybe_init_distributed``
    on NCCL with every all_reduce counted; writes both steps' params to
    ``out_path`` (rank 0)."""
    import torch

    sys.path.insert(0, HERE)
    from image_enhance_keras_tpu_torch.data.pipeline import PatchSampler, builtin_photos
    from image_enhance_keras_tpu_torch.engine import disable_tf32
    from image_enhance_keras_tpu_torch.models.weights import load_params
    from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, get_model, resolve_default_weights
    from image_enhance_keras_tpu_torch.parallel import make_mesh, maybe_init_distributed
    from image_enhance_keras_tpu_torch.train import trainer as pt
    from image_enhance_keras_tpu_torch.train.checkpoints import load_params_npz

    disable_tf32()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    demo = load_params_npz(resolve_default_weights(MODEL_REGISTRY["didbl"]))
    batch = torch.from_numpy(PatchSampler(builtin_photos(), hr_patch=DP_HR, batch_size=2, seed=SEED + rank).sample())

    def step():
        module = get_model("didbl")[0].to(dev)
        load_params(module, demo)
        state = pt.TrainState(module, pt.Adam(pt.mask_frozen(module), 1e-4, b1=0.9))
        state, m = pt.make_train_step(4, 0.5, mesh=make_mesh(1, devices=[dev]))(state, batch)
        return {k: v.detach().cpu() for k, v in state.params().items()}, float(m["loss"])

    out = {}
    if world == 1:
        out["without_group"] = step()
    calls = []
    dist = torch.distributed
    reduce = dist.all_reduce
    dist.all_reduce = lambda t, *a, **k: calls.append(t.numel()) or reduce(t, *a, **k)
    if not maybe_init_distributed("cuda"):
        raise RuntimeError("maybe_init_distributed did not join a group")
    out["with_group"] = step()
    out["backend"], out["world"], out["all_reduce_calls"] = dist.get_backend(), dist.get_world_size(), calls
    if rank == 0:
        torch.save(out, out_path)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _nccl_phase(mesh, tmp: str, failures: list, gpu: str) -> dict:
    """Phase 8c: the data-parallel step through an NCCL process group in
    child processes (one rank on a single card, whose step must equal the
    step without a group bit for bit; two ranks on two cards, whose step
    must match a one-process step over both batches within 1e-6); and
    ``learn`` / ``main_dirpath --devices`` one more than the cards, which
    must exit non-zero with the mesh's error."""
    import torch

    n_cards = torch.cuda.device_count()
    world = 2 if n_cards >= 2 else 1
    port = _free_port()
    path = os.path.join(tmp, "nccl.pt")
    env = {k: v for k, v in os.environ.items()}
    env.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}", JAX_NUM_PROCESSES=str(world))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--nccl-child", str(r), str(world), path],
                              env={**env, "JAX_PROCESS_ID": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=HERE) for r in range(world)]
    # one more device than the cards: both CLIs must fail loudly, with no fallback (started alongside)
    n = n_cards + 1
    clis = {"learn": ["-m", "image_enhance_keras_tpu_torch.cli.learn", "--devices", str(n), "--epochs", "1",
                      "--steps-per-epoch", "1", "--checkpoint-dir", os.path.join(tmp, "ck_refused")],
            "main_dirpath": ["-m", "image_enhance_keras_tpu_torch.cli.main_dirpath", tmp, "--devices", str(n)]}
    refusals = {k: subprocess.Popen([sys.executable, *v], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True, cwd=HERE) for k, v in clis.items()}
    want = f"requested {n} devices, have {n_cards}"
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0])
    out = {"world": world, "rcs": [p.returncode for p in procs]}
    if any(p.returncode for p in procs) or not os.path.exists(path):
        failures.append(f"8c NCCL child failed: {out['rcs']}: {logs[0][-2000:]}")
    else:
        out.update(_nccl_result(torch.load(path), world, failures, gpu))
    for k, p in refusals.items():
        try:
            text = p.communicate(timeout=240)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            text = p.communicate()[0]
        refused = p.returncode != 0 and want in text
        out[f"{k}_refused"] = refused
        print(f"[chip_smoke] 8c {k} --devices {n} on {n_cards} card(s): exit {p.returncode}, "
              f"{'says' if want in text else 'does not say'} {want!r}", flush=True)
        if not refused:
            failures.append(f"8c {k} --devices {n}: exit {p.returncode}: {text[-1500:]}")
    if os.path.exists(os.path.join(tmp, "ck_refused", "history.json")):
        failures.append("8c learn --devices wrote a history: it fell back to fewer devices")
    return out


def _nccl_result(got: dict, world: int, failures: list, gpu: str) -> dict:
    """Phase 8c's check of the NCCL ranks' step (see ``_nccl_phase``)."""
    import torch

    out = {"world": world}
    out.update(backend=got["backend"], all_reduce_calls=len(got["all_reduce_calls"]),
               loss=got["with_group"][1])
    if world == 1:
        a, b = got["with_group"][0], got["without_group"][0]
        equal = all(torch.equal(a[k], b[k]) for k in a) and got["with_group"][1] == got["without_group"][1]
        out["equal_without_group"] = equal
        ok = equal
    else:
        from image_enhance_keras_tpu_torch.data.pipeline import PatchSampler, builtin_photos
        from image_enhance_keras_tpu_torch.models.weights import load_params
        from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, get_model, resolve_default_weights
        from image_enhance_keras_tpu_torch.parallel import make_mesh
        from image_enhance_keras_tpu_torch.train import trainer as pt
        from image_enhance_keras_tpu_torch.train.checkpoints import load_params_npz

        demo = load_params_npz(resolve_default_weights(MODEL_REGISTRY["didbl"]))
        both = torch.cat([torch.from_numpy(PatchSampler(builtin_photos(), hr_patch=DP_HR, batch_size=2,
                                                        seed=SEED + r).sample()) for r in range(2)])
        module = get_model("didbl")[0].to("cuda:0")
        load_params(module, demo)
        state = pt.TrainState(module, pt.Adam(pt.mask_frozen(module), 1e-4, b1=0.9))
        state, _ = pt.make_train_step(4, 0.5, mesh=make_mesh(2))(state, both)
        ref = {k: v.detach().cpu() for k, v in state.params().items()}
        small = {k: (p.grad.abs() < 1e-6).cpu() for k, p in state.opt.params.items()}
        diff, diff_small = 0.0, 0.0
        for k, v in ref.items():
            d = (got["with_group"][0][k] - v).abs()
            m = small.get(k, torch.zeros_like(d, dtype=torch.bool))
            diff = max(diff, float(d[~m].max()) if (~m).any() else 0.0)
            diff_small = max(diff_small, float(d[m].max()) if m.any() else 0.0)
        out["param_max_diff_vs_one_process"] = [diff, diff_small]
        ok = diff <= 1e-6 and diff_small <= 2e-4  # where |grad| < 1e-6 Adam moves by up to the lr either way
    print(f"[chip_smoke] 8c DP step over a {world}-rank {out['backend']} group ({out['all_reduce_calls']} "
          f"all_reduce calls, loss {out['loss']:.7f}): {out} on {gpu}", flush=True)
    if not ok or out["backend"] != "nccl" or not out["all_reduce_calls"]:
        failures.append(f"8c NCCL step: {out}")
    return out


def _scale_out_phase(tmp: str, failures: list, gpu: str) -> dict:
    """Phase 8: scale-out (8a ShardedResolver, 8b the data-parallel step,
    8c NCCL and the refusal of too many devices)."""
    from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights

    t0 = time.time()
    mesh = _scale_mesh()
    names = [str(d) for d in mesh.local_devices()]
    print(f"[chip_smoke] 8 mesh: {json.dumps({'mesh': names})}", flush=True)
    out = {"mesh": names, "banded_kernels": _banded_dyn_kernels(failures, gpu)}
    weights = resolve_default_weights(MODEL_REGISTRY["didbl"])
    out["inference"] = _sharded_inference(weights, mesh, failures, gpu)
    out["patch_average"] = _sharded_patch_average(weights, mesh, failures, gpu)
    _phase("8a ShardedResolver", t0)
    t0 = time.time()
    out["dp_step"] = _dp_step_check(mesh, failures, gpu)
    _phase("8b data-parallel train step", t0)
    t0 = time.time()
    out["nccl"] = _nccl_phase(mesh, tmp, failures, gpu)
    _phase("8c NCCL process group and --devices refusals", t0)
    return out


# -- the long tail (phase 9) ---------------------------------------------------------

#: phase 9b: the knobs of --forward int8 (each read at call time), their
#: accumulator, and what each must equal; "s32" is the reference of MERGE55 s32
KNOB_RUNS = {
    "default": ({}, "bf16"),
    "s32": ({}, "s32"),
    "merge55": ({"IEK_INT8_MERGE55": "1"}, "bf16"),
    "merge55 s32": ({"IEK_INT8_MERGE55": "1"}, "s32"),
    "upq": ({"IEK_INT8_UPQ": "1"}, "bf16"),
    "upmm": ({"IEK_INT8_UPMM": "1"}, "bf16"),
}
#: Set5 SSIM-Y of each knob against the default int8 row (how JAX gates every int8 option)
KNOB_SSIM = 1e-3
#: 9c: the resize methods, and the float resizes' bound against the CPU at 0..255
RESIZE_METHODS = ("tf1_bilinear", "tf1_bicubic", "tf1_nearest", "pil_nearest", "pil_bilinear", "pil_bicubic",
                  "pil_lanczos", "pil_box")
RESIZE_ATOL = 1e-3
#: 9c: winograd against the direct conv, JAX's tolerance (tests/test_winograd.py)
WINO_TOL = 2e-4


class _Env:
    """Within the block: the environment variables set as given (restored after)."""

    def __init__(self, **env):
        self.env, self.saved = env, {}

    def __enter__(self):
        for k, v in self.env.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def _img_path(tmp: str, name: str, img) -> str:
    """``img`` written as ``name``.png where a PNG encoder is present (PIL or
    the native codec), else as .bmp (the numpy codec)."""
    from image_enhance_keras_tpu_torch.data import io as pio

    ext = ".png" if (pio._pil() is not None or pio._native() is not None) else ".bmp"
    path = os.path.join(tmp, name + ext)
    pio.imwrite(path, img)
    return path


def _compat_phase(tmp: str, failures: list, gpu: str) -> dict:
    """Phase 9a: ``compat.DifvdsrDouble`` on the card with the demo weights,
    each entry byte-equal to the ``SuperResolver`` call it runs: upscaleStepPatch
    on a seeded 128x128 file (``upscale_file``), upscalePatch (step 4) and the
    legacy upscale (step 16) on a seeded 64x64 file (``upscale_patch_average``),
    upVideo (``upscale_frame``); K3 launches and ms of each."""
    import numpy as np
    import torch

    from image_enhance_keras_tpu_torch import compat
    from image_enhance_keras_tpu_torch.data.io import imread
    from image_enhance_keras_tpu_torch.engine import SuperResolver

    m = compat.DifvdsrDouble(scale_factor=1)
    ref = SuperResolver(weights=m.weight_path, device="cuda")
    img128, img64 = _seeded_image(128, 128, SEED + 9), _seeded_image(64, 64, SEED + 19)
    os.makedirs(os.path.join(tmp, "compat"))
    os.makedirs(os.path.join(tmp, "ref"))
    p128 = _img_path(os.path.join(tmp, "compat"), "a", img128)
    r128 = _img_path(os.path.join(tmp, "ref"), "a", img128)
    p64 = _img_path(os.path.join(tmp, "compat"), "b", img64)
    m.create_model(load_weights=True)
    out = {"weights": os.path.relpath(m.weight_path, HERE), "device": str(m._resolver.device)}

    def timed(fn):
        fn()  # warm-up (cuDNN's algorithm choice)
        torch.cuda.synchronize()
        _zero_counts()
        t1 = time.time()
        y = fn()
        torch.cuda.synchronize()
        return y, 1e3 * (time.time() - t1), _counts()

    cases = {
        "upscaleStepPatch 128x128 (upscale_file)": (
            lambda: imread(m.upscaleStepPatch(p128)), lambda: imread(ref.upscale_file(r128))),
        "upscalePatch step 4, 64x64 (upscale_patch_average)": (
            lambda: m.upscalePatch(p64, return_image=True), lambda: ref.upscale_patch_average(img64, 32, 4)),
        "upscale step 16, 64x64 (upscale_patch_average)": (
            lambda: m.upscale(p64, return_image=True), lambda: ref.upscale_patch_average(img64, 32, 16)),
        "upVideo 64x64 (upscale_frame)": (lambda: m.upVideo(img64), lambda: ref.upscale_frame(img64)),
    }
    for name, (fn, want_fn) in cases.items():
        got, ms, counts = timed(fn)
        want = want_fn()
        same = bool(np.array_equal(got, want))
        k3 = counts.get("upsample_phase_tf1", 0)
        out[name] = {"byte_equal": same, "ms": ms, "k3_launches": k3, "launches": counts, "shape": list(got.shape)}
        print(f"[chip_smoke] 9a compat {name}: {got.shape}, byte-equal {same}, {ms:.2f} ms, K3 {k3} launches "
              f"{counts} on {gpu}", flush=True)
        if not same or not k3 or float(got.std()) < 1.0:
            failures.append(f"9a compat {name}: byte-equal {same}, K3 launches {k3}")
    return out


def _knob_forwards(weights: str, qp, failures: list, gpu: str) -> dict:
    """Phase 9b: ``--forward int8 --dtype bfloat16`` under each of KNOB_RUNS
    at 128x128 in patch mode and 512x512 in fast mode (phase 2's quantized
    tree): launches, ms per image, and the byte checks (MERGE55 equal to the
    unmerged run of its accumulator; UPQ with K3q and X1u and no K3, and
    byte-equal to itself with the plain x4, K3q and blocks swapped in; UPMM
    with no K3)."""
    import numpy as np

    from image_enhance_keras_tpu_torch.engine import SuperResolver

    imgs = {"patch 128x128": _seeded_image(128, 128, SEED), "fast 512x512": _seeded_image(512, 512, SEED + 3)}
    out = {}
    for label, img in imgs.items():
        r = SuperResolver(weights=weights, forward="int8", dtype="bfloat16", mode=label.split()[0], device="cuda")
        r._qparams = qp
        ys = {}
        for name, (env, acc) in KNOB_RUNS.items():
            with _Env(IEK_INT8_ACC=acc, **env):
                y, s, counts = _timed_upscale(r, img)
            ys[name] = y
            row = {"ms": 1e3 * s, "out_mpix_s": y.shape[0] * y.shape[1] / 1e6 / s, "launches": counts}
            want = {"light53_int8_xla": 18, "light_int8_xla": 6, "upsample_phase_tf1": 1}
            if name == "upq":  # X1u forms its skip from the LR map: no K3
                want = {"light53_int8_xla": 17, "light53_int8_xla_upq": 1, "light_int8_xla": 6,
                        "upsample_quant_tf1": 1}
            elif name == "upmm":
                want = {"light53_int8_xla": 18, "light_int8_xla": 6}
            got_l = {k: v for k, v in counts.items() if not k.endswith("_bf16")}
            row["launches_expected"] = got_l == want
            if got_l != want:
                failures.append(f"9b {label} {name}: launches {got_l}, expected {want}")
            if name.startswith("merge55"):
                row["byte_equal_unmerged"] = bool(np.array_equal(y, ys["default" if acc == "bf16" else "s32"]))
                if not row["byte_equal_unmerged"]:
                    failures.append(f"9b {label} {name}: not byte-equal to the unmerged forward")
            if name == "upq":
                with _Env(IEK_INT8_ACC=acc, **env), _Swapped("plain_x4"), _Swapped("plain_blocks"):
                    row["byte_equal_plain"] = bool(np.array_equal(y, r.upscale(img)))
                if not row["byte_equal_plain"]:
                    failures.append(f"9b {label} {name}: not byte-equal to the forward on the plain versions")
            if name in ("upq", "upmm"):
                row["u8_max_diff_vs_default"], frac = _u8_agreement(y, ys["default"])
                row["differing_vs_default"] = int(round(frac * y.size))
            out[f"{label} {name}"] = row
            print(f"[chip_smoke] 9b int8 bf16 {label} {name}: {row['ms']:.2f} ms, {row['out_mpix_s']:.3f} "
                  f"out-Mpix/s, launches {counts}"
                  + (f", byte-equal unmerged {row['byte_equal_unmerged']}" if "byte_equal_unmerged" in row else "")
                  + (f", byte-equal plain {row['byte_equal_plain']}" if "byte_equal_plain" in row else "")
                  + (f", vs default max {row['u8_max_diff_vs_default']} on {row['differing_vs_default']} values"
                     if "differing_vs_default" in row else "") + f" on {gpu}", flush=True)
        del r
    return out


def _knob_kernels(qp, failures: list, gpu: str) -> list:
    """Phase 9b: K3q and X1u on the int8 forward's own activations (the body
    output of the 128x128 image's 9 patches, (9,96,96,128) bf16, and its x4
    codes at (9,384,384,128)), bit-equal to their plain versions (X1u under
    the bf16 and s32 accumulators), with ms per call, device ms (K3q by
    _device_ms, X1u by queued CUDA events), the bound and, for X1u,
    torch._int_mm over an int8 im2col of its convs (as the X rows); launches
    are set from the main path's run."""
    import torch

    from image_enhance_keras_tpu_torch.models.didbl_pallas import _stacked_actc, apply_didbl_int8_xla_body
    from image_enhance_keras_tpu_torch.ops.cuda import int8_xla as kx
    from image_enhance_keras_tpu_torch.ops.cuda import upsample as kup
    from image_enhance_keras_tpu_torch.tiling.tiles import extract_tiles, pad_to_plan, plan_tiles

    img = _seeded_image(128, 128, SEED)
    plan = plan_tiles(128, 128, patch=96, step=64, scale=4, crop=8)
    pt = qp["tail53_0"]
    sx = pt["actc"]["x"]
    act = _stacked_actc(pt, ("a", "b"))
    convs = [pt[c][k] for c in ("conv_a1", "conv_a2", "conv_b1", "conv_b2") for k in ("qf", "sf", "bias")]
    rows = []
    with torch.inference_mode():
        tiles = extract_tiles(pad_to_plan(torch.from_numpy(img).cuda().float(), plan), plan) / 255.0
        h = apply_didbl_int8_xla_body(qp, tiles).contiguous()
        xq = kup.upsample_quant_tf1(h, 4, sx)
        c = int(h.shape[-1])
        # K3q
        got, want = kup.upsample_quant_tf1(h, 4, sx), kup.upsample_quant_plain(h, 4, sx)
        torch.cuda.synchronize()
        exact = bool(torch.equal(got, want))
        if not exact:
            failures.append(f"upsample_quant_tf1 (K3q): not bit-equal to plain (differ on "
                            f"{(got != want).float().mean().item():.3g} of values)")
        ms = _time_ms(lambda: kup.upsample_quant_tf1(h, 4, sx))
        nbytes = 2.0 * h.numel() + 16.0 * h.numel()
        bound_ms, bound_by = _bound(11.0 * 16 * h.numel(), PEAK_F32_FLOPS, nbytes)
        dev_ms, how = _device_ms(lambda: kup.upsample_quant_tf1(h, 4, sx), bound_ms)
        if dev_ms < bound_ms:
            failures.append(f"upsample_quant_tf1 (K3q): {dev_ms:.4f} ms device ({how}) is below its bound")
        row = {"name": "upsample_quant_tf1", "route": "cuda",
               "source": "image_enhance_keras_tpu_torch/csrc/upsample.cu",
               "replaces": K_UPQ_REPLACES["upsample_quant_tf1"], "launches": None,
               "max_abs_err": (got.int() - want.int()).abs().max().item(), "tolerance": 0.0, "ms": ms,
               "plain_ms": _time_ms(lambda: kup.upsample_quant_plain(h, 4, sx), iters=5, warmup=1),
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
               "library": "none: torch has no call for the TF1 (asymmetric) x4 with a per-channel int8 "
                          "quantize; F.interpolate's bilinear is half-pixel",
               "shape": list(h.shape), "dtype": "bfloat16", "bit_equal": exact, "device_ms": dev_ms,
               "device_ms_by": how, "gbps": nbytes / (dev_ms * 1e-3) / 1e9,
               "bound_share": bound_ms / dev_ms}
        print(f"[chip_smoke] 9b K3q upsample_quant_tf1 {tuple(h.shape)} -> int8 {tuple(got.shape)}: bit-equal "
              f"{exact}; {ms:.4f} ms per call, {dev_ms:.4f} ms device ({how}), {row['plain_ms']:.3f} ms plain, "
              f"bound {bound_ms:.4f} ms ({bound_by}), {row['gbps']:.1f} GB/s, {100 * row['bound_share']:.1f}% of "
              f"the byte bound on {gpu}", flush=True)
        rows.append(row)
        del got, want
        # X1u: its skip formed from the LR map h
        row = {"shape": list(xq.shape)}
        for acc in ("bf16", "s32"):
            got = kx.light53_int8_xla_upq(xq, h, *convs, act, acc=acc)
            want = kx.light53_int8_xla_upq_plain(xq, h, *convs, act, acc=acc)
            torch.cuda.synchronize()
            row[f"bit_equal_{acc}"] = bool(torch.equal(got, want))
            row[f"max_abs_err_{acc}"] = (got.float() - want.float()).abs().max().item()
            if not row[f"bit_equal_{acc}"]:
                failures.append(f"light53_int8_xla_upq (X1u, acc {acc}): not bit-equal to plain")
            row[f"ms_{acc}"] = _time_ms(lambda: kx.light53_int8_xla_upq(xq, h, *convs, act, acc=acc))
            del got, want
        fn = lambda: kx.light53_int8_xla_upq(xq, h, *convs, act)  # noqa: E731
        ops = 2.0 * 68 * c * c * xq[..., 0].numel()
        # the codes read and the bf16 output written (1 + 2 bytes an HR element), the LR map read once
        bound_ms, bound_by = _bound(ops, PEAK_INT8_OPS, (1.0 + 2.0) * xq.numel() + 2.0 * h.numel() + 68 * c * c)
        dev_ms, how = _queued_ms(fn), "queued CUDA events"
        if dev_ms < bound_ms:
            failures.append(f"light53_int8_xla_upq (X1u): {dev_ms:.4f} ms device ({how}) is below its bound")
        xq_f = xq.float()
        aq = kx._first(xq_f, pt["conv_a1"]["qf"], pt["conv_a1"]["sf"], pt["conv_a1"]["bias"], act[0], "bf16", False)
        bq = kx._first(xq_f, pt["conv_b1"]["qf"], pt["conv_b1"]["sf"], pt["conv_b1"]["bias"], act[1], "bf16", False)
        pairs = [(xq, pt["conv_a1"]["qf"]), (aq.to(torch.int8), pt["conv_a2"]["qf"]), (xq, pt["conv_b1"]["qf"]),
                 (bq.to(torch.int8), pt["conv_b2"]["qf"])]
        del xq_f, aq, bq
        lib_ms = _time_ms(_int_mm_convs(pairs), iters=3, warmup=1)
        del pairs
        rows.append({
            "name": "light53_int8_xla_upq", "route": "cuda",
            "source": "image_enhance_keras_tpu_torch/csrc/int8_conv.cu",
            "replaces": K_UPQ_REPLACES["light53_int8_xla_upq"], "launches": None,
            "max_abs_err": max(row["max_abs_err_bf16"], row["max_abs_err_s32"]), "tolerance": 0.0,
            "ms": row["ms_bf16"], "plain_ms": _time_ms(lambda: kx.light53_int8_xla_upq_plain(xq, h, *convs, act),
                                                       iters=3, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "library": "torch._int_mm over an int8 im2col of the block's convs (s32 sums only)",
            "device_ms": dev_ms, "device_ms_by": how, "launch_ms": _launch_breakdown(fn),
            "tops": ops / (row["ms_bf16"] * 1e-3) / 1e12, "dtype": "bfloat16", **row,
        })
        r = rows[-1]
        print(f"[chip_smoke] 9b X1u light53_int8_xla_upq {tuple(xq.shape)}: bit-equal bf16 {r['bit_equal_bf16']} "
              f"s32 {r['bit_equal_s32']}; {r['ms_bf16']:.4f} ms (acc bf16), {r['ms_s32']:.4f} ms (s32), "
              f"{dev_ms:.4f} ms device ({how}), {r['plain_ms']:.3f} ms plain, {lib_ms:.4f} ms _int_mm over "
              f"im2col, bound {bound_ms:.4f} ms ({bound_by}), {r['tops']:.1f} TOPS; device ms by launch "
              f"{ {k: round(v, 4) for k, v in r['launch_ms'].items()} } on {gpu}", flush=True)
    return rows


def _knob_set5(weights: str, failures: list, gpu: str) -> dict:
    """Phase 9b: Set5 PSNR-Y / SSIM-Y of fast ``--forward int8`` under each
    knob beside the default row (one calibration on the bundled photos,
    shared), each within KNOB_SSIM of the default on SSIM-Y."""
    from image_enhance_keras_tpu_torch.engine import SuperResolver
    from image_enhance_keras_tpu_torch.eval import evaluate_model

    set5 = os.path.join(HERE, "data_set5")
    r = SuperResolver(weights=weights, forward="int8", mode="fast", device="cuda")
    out = {}
    for name in ("default", "merge55", "upq", "upmm"):
        env, acc = KNOB_RUNS[name]
        with _Env(IEK_INT8_ACC=acc, **env):
            _, means = evaluate_model(r, set5, verbose=False)
        out[name] = {"psnr_y": means["psnr_y"], "ssim_y": means["ssim_y"]}
        d = means["ssim_y"] - out["default"]["ssim_y"]
        print(f"[chip_smoke] 9b Set5 fast int8 {name}: PSNR-Y {means['psnr_y']:.4f} SSIM-Y {means['ssim_y']:.5f} "
              f"(SSIM-Y {d:+.5f} against the default, bound {KNOB_SSIM}) on {gpu}", flush=True)
        if abs(d) > KNOB_SSIM:
            failures.append(f"9b Set5 int8 {name}: SSIM-Y {means['ssim_y']:.5f} vs default "
                            f"{out['default']['ssim_y']:.5f}")
    out["calib_source"] = r.int8_calib_source
    return out


def _ops_tail_phase(tmp: str, failures: list, gpu: str) -> dict:
    """Phase 9c: every resize method (``resize2d``; ``resize_pil_uint8`` for the
    PIL ones) and ``uniform_filter`` on the card against the same call on
    the CPU, with the values that differ; ``winograd_conv2d_same`` F(2,3)
    against ``F.conv2d`` (TF32 off) at (9,96,96,128), both timed; and
    ``utils.profiling.trace`` around one such conv (a Chrome trace with the
    card's kernels in it)."""
    import glob

    import torch
    import torch.nn.functional as F

    from image_enhance_keras_tpu_torch.ops import filters, resize, winograd
    from image_enhance_keras_tpu_torch.utils.profiling import StageTimer, trace

    gen = torch.Generator().manual_seed(SEED + 9)
    x = torch.rand((2, 37, 53, 3), generator=gen) * 255
    u8 = torch.randint(0, 256, (2, 37, 53, 3), generator=gen, dtype=torch.uint8)
    out = {"resize": {}}
    for method in RESIZE_METHODS:
        row = {}
        for hw in ((74, 106), (19, 23), (148, 212)):
            got = resize.resize2d(x.cuda(), hw, method).cpu()
            want = resize.resize2d(x, hw, method)
            d = (got - want).abs()
            row[f"{hw[0]}x{hw[1]}"] = {"max_abs_diff": d.max().item(), "differing": int((d > 0).sum())}
            if d.max().item() > RESIZE_ATOL:
                failures.append(f"9c resize2d {method} {hw}: card vs CPU max |d| {d.max().item():.3g}")
            if method.startswith("pil_"):
                g8 = resize.resize_pil_uint8(u8.cuda(), hw, method).cpu()
                w8 = resize.resize_pil_uint8(u8, hw, method)
                d8 = (g8 - w8).abs()
                row[f"{hw[0]}x{hw[1]} uint8"] = {"max_abs_diff": d8.max().item(), "differing": int((d8 > 0).sum())}
                if d8.max().item() > 1:
                    failures.append(f"9c resize_pil_uint8 {method} {hw}: card vs CPU max {d8.max().item()}")
        out["resize"][method] = row
        print(f"[chip_smoke] 9c {method} card vs CPU: {row} on {gpu}", flush=True)
    uf = {}
    for size in (3, 4, 7):
        d = (filters.uniform_filter(x.cuda(), size).cpu() - filters.uniform_filter(x, size)).abs()
        uf[size] = {"max_abs_diff": d.max().item(), "differing": int((d > 0).sum())}
        if d.max().item() > RESIZE_ATOL:
            failures.append(f"9c uniform_filter size {size}: card vs CPU max |d| {d.max().item():.3g}")
    out["uniform_filter"] = uf
    print(f"[chip_smoke] 9c uniform_filter card vs CPU: {uf} on {gpu}", flush=True)
    # winograd F(2,3) against the direct conv at the block convs' shape
    xs = torch.randn((9, 96, 96, 128), generator=gen).cuda()
    w = (torch.randn((3, 3, 128, 128), generator=gen) * 0.05).cuda()
    b = (torch.randn(128, generator=gen) * 0.01).cuda()
    timer = StageTimer()
    with torch.inference_mode():
        def direct():
            return F.conv2d(xs.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, padding=1).permute(0, 2, 3, 1)

        with timer("winograd"):
            got = winograd.winograd_conv2d_same(xs, w, b, m=2)
        with timer("direct"):
            want = direct()
        torch.cuda.synchronize()
        d = (got - want).abs()
        ok = bool((d <= WINO_TOL + WINO_TOL * want.abs()).all())
        wino_ms = _time_ms(lambda: winograd.winograd_conv2d_same(xs, w, b, m=2), iters=5, warmup=1)
        conv_ms = _time_ms(direct, iters=5, warmup=1)
        trace_dir = os.path.join(tmp, "trace")
        with trace(trace_dir) as where:
            winograd.winograd_conv2d_same(xs, w, b, m=2)
            torch.cuda.synchronize()
    files = glob.glob(os.path.join(where, "*.json"))
    text = open(files[0]).read() if files else ""
    traced = bool(files) and '"cat": "kernel"' in text
    out["winograd"] = {"shape": list(xs.shape), "m": 2, "k": 3, "max_abs_err": d.max().item(),
                       "within_tol": ok, "ms": wino_ms, "conv2d_ms": conv_ms, "flops_ratio": winograd.flops_ratio(2, 3),
                       "stage_timer": timer.report()}
    out["trace"] = {"files": len(files), "has_kernels": traced}
    print(f"[chip_smoke] 9c winograd_conv2d_same F(2,3) {tuple(xs.shape)} vs F.conv2d (TF32 off): max |d| "
          f"{d.max().item():.3g} (within {WINO_TOL} + {WINO_TOL}|ref|: {ok}); {wino_ms:.3f} ms vs "
          f"{conv_ms:.3f} ms; profiling.trace wrote {len(files)} Chrome trace(s), kernels in it {traced} on {gpu}",
          flush=True)
    if not ok:
        failures.append(f"9c winograd_conv2d_same: max |d| {d.max().item():.3g} beyond {WINO_TOL}")
    if not traced:
        failures.append("9c profiling.trace: no Chrome trace with device kernels")
    return out


def _long_tail_phase(tmp: str, qp, failures: list, rows: list, gpu: str) -> dict:
    """Phase 9: compat on the card (9a), the int8 knobs (9b: forwards, K3q
    and X1u rows, Set5), the ops tail (9c)."""
    from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights

    weights = resolve_default_weights(MODEL_REGISTRY["didbl"])
    t0 = time.time()
    out = {"compat": _compat_phase(tmp, failures, gpu)}
    _phase("9a compat on the card", t0)
    t0 = time.time()
    out["knobs"] = _knob_forwards(weights, qp, failures, gpu)
    krows = _knob_kernels(qp, failures, gpu)
    for row in krows:  # launches on the main path: the serving profile under IEK_INT8_UPQ, fast 512x512
        row["launches"] = out["knobs"]["fast 512x512 upq"]["launches"].get(row["name"], 0)
    rows += krows
    out["set5"] = _knob_set5(weights, failures, gpu)
    _phase("9b the int8 knobs", t0)
    t0 = time.time()
    out["ops"] = _ops_tail_phase(tmp, failures, gpu)
    _phase("9c the ops tail", t0)
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import torch.nn.functional as F

    from image_enhance_keras_tpu_torch.cli import main_dirpath
    from image_enhance_keras_tpu_torch.data.io import imread, imwrite
    from image_enhance_keras_tpu_torch.engine import SuperResolver, disable_tf32
    from image_enhance_keras_tpu_torch.models import didbl_pallas
    from image_enhance_keras_tpu_torch.models.didbl_pallas import _conv, _stacked
    from image_enhance_keras_tpu_torch.models.weights import params_from_numpy
    from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights
    from image_enhance_keras_tpu_torch.ops.cuda import _build
    from image_enhance_keras_tpu_torch.ops.cuda import blocks as kb
    from image_enhance_keras_tpu_torch.ops.cuda import int8_blocks as ki8
    from image_enhance_keras_tpu_torch.ops.cuda import tower as kt
    from image_enhance_keras_tpu_torch.ops.cuda import upsample as kup
    from image_enhance_keras_tpu_torch.ops.resize import upsample_phase_plain
    from image_enhance_keras_tpu_torch.tiling.tiles import extract_tiles, pad_to_plan, plan_tiles
    from image_enhance_keras_tpu_torch.train.checkpoints import load_params_npz

    failures: list[str] = []
    t_all = time.time()

    # -- 0. the card -------------------------------------------------------
    t0 = time.time()
    gpu = _gpu_name_power()
    kind = torch.cuda.get_device_name(0)
    disable_tf32()
    print(f"[chip_smoke] card: {gpu} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}",
          flush=True)
    _phase("0 card", t0)

    # -- 1. build ----------------------------------------------------------
    t0 = time.time()
    _build.build_all()
    for stem, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"[chip_smoke] nvcc {stem}: {line.strip()}", flush=True)
    build_s = time.time() - t0
    # the int8 kernels' products are tensor-core wgmma (SASS *GMMA), no
    # __dp4a; the block and chain kernels' 3xTF32 products are wgmma too
    sass = {}
    for stem in ("int8_blocks", "tower", "blocks", "int8_conv"):
        try:
            sass[stem] = _sass_counts(_build.build_all()[stem])
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            sass[stem] = None
            failures.append(f"csrc/{stem}.cu: the SASS could not be read ({e})")
        print(f"[chip_smoke] SASS of csrc/{stem}.cu: "
              f"{ {k: v for k, v in (sass[stem] or {}).items() if k not in ('functions', 'ops')} }", flush=True)
    if sass["int8_blocks"] is not None and (sass["int8_blocks"]["GMMA"] == 0 or sass["int8_blocks"]["IDP"] > 0):
        failures.append(f"int8 kernels: expected wgmma (GMMA) and no dp4a (IDP) in the SASS, got {sass['int8_blocks']}")
    if sass["int8_blocks"] is not None:
        # every int8 kernel function but the dynamic form's abs-max passes and
        # its requantization pass runs its convs on wgmma
        fns8 = sass["int8_blocks"]["functions"]
        for k, v in sorted(fns8.items()):
            print(f"[chip_smoke] int8 kernel function {k[:110]}: {v} GMMA lines", flush=True)
        without = [k for k, v in fns8.items() if v == 0 and "absmax" not in k and "requant" not in k]
        if without or len(fns8) != 23:
            failures.append(f"int8 kernels: expected 23 kernel functions (17 of K4/K5, 6 of X3), "
                            f"wgmma in all but the 3 abs-max passes and the requantization pass; got {len(fns8)}, "
                            f"none in {without}")
    # X4: its 15 conv functions (bf16 / float32 x static and dynamic, int8 codes
    # static; 64, 96 and 128 output channels a column block) and the 6 of X1,
    # X2 and X1u (xla_block_kernel: two launches each) on wgmma, no dp4a; the 2
    # abs-max passes without
    if sass["int8_conv"] is not None:
        fns4 = sass["int8_conv"]["functions"]
        convs4 = {k: v for k, v in fns4.items() if "conv3_kernel" in k or "xla_block_kernel" in k}
        print(f"[chip_smoke] X4, X1, X2 and X1u kernel functions' GMMA lines: "
              f"{ {k.split('(')[0][-40:]: v for k, v in sorted(convs4.items())} }", flush=True)
        if sass["int8_conv"]["IDP"] > 0 or len(convs4) != 21 or min(convs4.values()) == 0 or len(fns4) != 23:
            failures.append(f"X4, X1, X2 and X1u: expected 23 kernel functions, X4's 15 conv functions and the 6 "
                            f"of X1, X2 and X1u each with wgmma (GMMA), no dp4a (IDP); got {len(fns4)}, GMMA lines "
                            f"{sorted(convs4.values())}, IDP {sass['int8_conv']['IDP']}")
    # every kernel function of the block and chain libraries, the bf16 forms'
    # (two launches of two block kinds, one chain kernel of two kinds, on the
    # tile of csrc/conv_bf16.cuh) included; those also hold the tile's TMA
    # window loads and bulk weight copies
    for stem, what, n_bf16 in (("tower", "chain", 2), ("blocks", "block", 4)):
        if sass[stem] is None:
            continue
        fns = sass[stem]["functions"]
        without = [k for k, v in fns.items() if v == 0]
        bf16_fns = [k for k in fns if "bf16_tile" in k]  # the bf16 tile's kernels
        copies = {k: sass[stem]["ops"][k] for k in bf16_fns}
        print(f"[chip_smoke] {what} kernels' GMMA lines by function (bf16 forms {len(bf16_fns)}): "
              f"{sorted(fns.values())}; bf16 copies {sorted(copies.values(), key=str)}", flush=True)
        no_copy = [k for k, v in copies.items() if not (v["UTMALDG"] and v["UBLKCP"])]
        if sass[stem]["GMMA"] == 0 or without or len(bf16_fns) != n_bf16 or no_copy:
            failures.append(f"{what} kernels: expected wgmma (GMMA) in the SASS of every kernel, {n_bf16} "
                            f"bf16 kernels with TMA (UTMALDG) and bulk copies (UBLKCP); got {sass[stem]['GMMA']} "
                            f"GMMA lines, none in {without}, bf16 kernels {sorted(bf16_fns)}, without copies "
                            f"{no_copy}")
    _phase(f"1 build ({build_s:.2f} s)", t0)

    # -- 2. kernels against their plain versions ------------------------------
    t0 = time.time()
    dev = torch.device("cuda")
    weights = resolve_default_weights(MODEL_REGISTRY["didbl"])
    params = params_from_numpy(load_params_npz(weights), dev)
    img = _seeded_image(128, 128, SEED)
    plan = plan_tiles(128, 128, patch=96, step=64, scale=4, crop=8)
    with torch.inference_mode():
        tiles = extract_tiles(pad_to_plan(torch.from_numpy(img).to(dev).float(), plan), plan) / 255.0
        x53 = torch.relu(_conv(tiles, params["level1"])).contiguous()
        h = x53
        for i in range(16):
            p = params[f"body53_{i}"]
            h = kb.light53_block_plain(h, *(p[c][k] for c in ("conv_a1", "conv_a2", "conv_b1", "conv_b2")
                                            for k in ("kernel", "bias")))
        xl = h.contiguous()
    if tuple(x53.shape) != SHAPE:
        failures.append(f"main-path block input shape {tuple(x53.shape)} != {SHAPE}")
    print(f"[chip_smoke] block inputs: light53 max|x|={x53.abs().max().item():.4g}, "
          f"light max|x|={xl.abs().max().item():.4g}", flush=True)

    p53, pl = params["body53_0"], params["light_0"]
    a53 = [p53[c][k] for c in ("conv_a1", "conv_a2", "conv_b1", "conv_b2") for k in ("kernel", "bias")]
    al = [pl[c][k] for c in ("conv_a", "conv_b") for k in ("kernel", "bias")]

    def oihw(w):
        return w.permute(3, 2, 0, 1).contiguous()

    def lib53(xc, wa1, ba1, wa2, ba2, wb1, bb1, wb2, bb2):
        a = F.conv2d(F.relu(F.conv2d(xc, wa1, ba1, padding=1)), wa2, ba2, padding=2)
        b = F.conv2d(F.relu(F.conv2d(xc, wb1, bb1, padding=2)), wb2, bb2, padding=1)
        return 0.9 * xc + 0.1 * (a + b)

    def libl(xc, w1, b1, w2, b2):
        return xc + 0.1 * F.conv2d(F.relu(F.conv2d(xc, w1, b1, padding=1)), w2, b2, padding=1)

    n, hh, ww, c = SHAPE
    specs = [
        ("light53_block", kb.fused_light53_block, kb.light53_block_plain, lib53, x53, a53, 68,
         "image_enhance_keras_tpu/ops/pallas/blocks.py:181"),
        ("light_block", kb.fused_light_block, kb.light_block_plain, libl, xl, al, 18,
         "image_enhance_keras_tpu/ops/pallas/blocks.py:154"),
    ]
    rows = []
    with torch.inference_mode():
        for name, kern, plain, lib, x, args, taps, replaces in specs:
            got = kern(x, *args)
            want = plain(x, *args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not (err <= KERNEL_ATOL):
                failures.append(f"{name}: max |kernel - plain| = {err:.3g} > {KERNEL_ATOL}")
            ms = _time_ms(lambda: kern(x, *args))
            plain_ms = _time_ms(lambda: plain(x, *args))
            xc = x.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
            largs = [oihw(a) if a.dim() == 4 else a for a in args]
            lib_out = lib(xc, *largs).permute(0, 2, 3, 1)
            lib_err = (lib_out - want).abs().max().item()
            library_ms = _time_ms(lambda: lib(xc, *largs))
            flops = 2.0 * taps * c * c * n * hh * ww
            nbytes = 4.0 * (2 * x.numel() + sum(a.numel() for a in args))
            bounds = _f32_bounds(flops, nbytes)
            # ragged crops of the path's input: tiles cut by the image's edge
            ragged = {}
            for n_i, rh, rw in F32_RAGGED:
                xr = x[n_i:n_i + 1, :rh, :rw].contiguous()
                er = (kern(xr, *args) - plain(xr, *args)).abs().max().item()
                ragged[f"{rh}x{rw}"] = er
                print(f"[chip_smoke] {name} ragged {tuple(xr.shape)}: err {er:.3g} vs plain "
                      f"(bound {KERNEL_ATOL})", flush=True)
                if not (er <= KERNEL_ATOL):
                    failures.append(f"{name} on a ragged {tuple(xr.shape)} input: |kernel - plain| = "
                                    f"{er:.3g} (bound {KERNEL_ATOL})")
            rows.append({
                "name": name, "route": "cuda",
                "source": "image_enhance_keras_tpu_torch/csrc/blocks.cu",
                "replaces": replaces, "launches": None, "max_abs_err": err,
                "tolerance": KERNEL_ATOL, "ms": ms, "plain_ms": plain_ms, **bounds,
                "library_ms": library_ms, "max_abs_err_ragged": ragged,
                "tflops": flops / (ms * 1e-3) / 1e12,
            })
            print(f"[chip_smoke] {name}: err {err:.3g} (F.conv2d formulation vs plain {lib_err:.3g}), "
                  f"{ms:.3f} ms kernel, {plain_ms:.3f} ms plain, {library_ms:.3f} ms F.conv2d, "
                  f"bound {bounds['bound_ms']:.3f} ms (CUDA cores {bounds['bound_f32_cores_ms']:.3f}, "
                  f"3xTF32 {bounds['bound_tf32x3_ms']:.3f}), {rows[-1]['tflops']:.2f} TFLOP/s", flush=True)
    # the chains (K6, K7) over the 16 stacked Light53 and 6 stacked Light
    # sets, on the chain path's own activations: the level1 output, then K6's
    # output; each against its plain version and against K1 x16 / K2 x6
    l53c = ("conv_a1", "conv_a2", "conv_b1", "conv_b2")
    s53 = _stacked([params[f"body53_{i}"] for i in range(16)], l53c)
    sl = _stacked([params[f"light_{i}"] for i in range(6)], ("conv_a", "conv_b"))

    def chained(block, k_blocks):
        """block applied k_blocks times, block i taking entry i of each stacked argument."""
        def run(x, *args):
            for i in range(k_blocks):
                x = block(x, *(a[i] for a in args))
            return x
        return run

    def per_block(block, names, convs, k_blocks):
        """block applied to the tree's own per-block tensors, as the pallas
        path calls it (their packed weights are cached on them)."""
        blocks = [[params[f"{names}_{i}"][cv][k] for cv in convs for k in ("kernel", "bias")]
                  for i in range(k_blocks)]

        def run(x, *_stacked_args):
            for a in blocks:
                x = block(x, *a)
            return x
        return run

    with torch.inference_mode():
        xc6 = x53
        xc7 = kt.fused_light53_chain(xc6, *s53).contiguous()
    chain_specs = [
        ("light53_chain", kt.fused_light53_chain, kt.light53_chain_plain,
         per_block(kb.fused_light53_block, "body53", l53c, 16), chained(lib53, 16), xc6, s53, 16 * 68,
         "image_enhance_keras_tpu/ops/pallas/tower.py:166"),
        ("light_chain", kt.fused_light_chain, kt.light_chain_plain,
         per_block(kb.fused_light_block, "light", ("conv_a", "conv_b"), 6), chained(libl, 6), xc7, sl,
         6 * 18,
         "image_enhance_keras_tpu/ops/pallas/tower.py:191"),
    ]
    with torch.inference_mode():
        for name, kern, plain, blocks, lib, x, args, taps, replaces in chain_specs:
            got = kern(x, *args)
            want = plain(x, *args)
            by_blocks = blocks(x, *args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            err_blocks = (got - by_blocks).abs().max().item()
            if not (err <= CHAIN_ATOL and err_blocks <= CHAIN_ATOL):
                failures.append(f"{name}: max |kernel - plain| = {err:.3g}, |kernel - blocks| = "
                                f"{err_blocks:.3g} (bound {CHAIN_ATOL})")
            ms = _time_ms(lambda: kern(x, *args))
            plain_ms = _time_ms(lambda: plain(x, *args), iters=3, warmup=1)
            blocks_ms = _time_ms(lambda: blocks(x, *args))
            xc = x.permute(0, 3, 1, 2)
            largs = [a.permute(0, 4, 3, 1, 2).contiguous() if a.dim() == 5 else a for a in args]
            lib_err = (lib(xc, *largs).permute(0, 2, 3, 1) - want).abs().max().item()
            library_ms = _time_ms(lambda: lib(xc, *largs), iters=3, warmup=1)
            flops = 2.0 * taps * c * c * n * hh * ww
            nbytes = 4.0 * (2 * x.numel() + sum(a.numel() for a in args))
            bounds = _f32_bounds(flops, nbytes)
            # ragged crops of the path's input: tiles cut by the image's edge
            ragged = {}
            for n_i, rh, rw in F32_RAGGED:
                xr = x[n_i:n_i + 1, :rh, :rw].contiguous()
                gr = kern(xr, *args)
                er = (gr - plain(xr, *args)).abs().max().item()
                erb = (gr - blocks(xr, *args)).abs().max().item()
                ragged[f"{rh}x{rw}"] = max(er, erb)
                print(f"[chip_smoke] {name} ragged {tuple(xr.shape)}: err {er:.3g} vs plain, {erb:.3g} "
                      f"vs the per-block kernels (bound {CHAIN_ATOL})", flush=True)
                if not (er <= CHAIN_ATOL and erb <= CHAIN_ATOL):
                    failures.append(f"{name} on a ragged {tuple(xr.shape)} input: |kernel - plain| = "
                                    f"{er:.3g}, |kernel - blocks| = {erb:.3g} (bound {CHAIN_ATOL})")
            rows.append({
                "name": name, "route": "cuda",
                "source": "image_enhance_keras_tpu_torch/csrc/tower.cu",
                "replaces": replaces, "launches": None, "max_abs_err": err,
                "tolerance": CHAIN_ATOL, "ms": ms, "plain_ms": plain_ms, **bounds,
                "library_ms": library_ms,
                "blocks_ms": blocks_ms, "max_abs_err_vs_blocks": err_blocks,
                "max_abs_err_ragged": ragged,
                "tflops": flops / (ms * 1e-3) / 1e12,
            })
            print(f"[chip_smoke] {name}: err {err:.3g} vs plain, {err_blocks:.3g} vs the per-block "
                  f"kernels (F.conv2d chain vs plain {lib_err:.3g}), {ms:.3f} ms kernel, "
                  f"{blocks_ms:.3f} ms per-block kernels, {plain_ms:.3f} ms plain, {library_ms:.3f} ms "
                  f"F.conv2d, bound {bounds['bound_ms']:.3f} ms (CUDA cores {bounds['bound_f32_cores_ms']:.3f}, "
                  f"3xTF32 {bounds['bound_tf32x3_ms']:.3f}), {rows[-1]['tflops']:.2f} TFLOP/s", flush=True)
    del x53, xl, h, xc6, xc7, s53, sl
    rows += _bf16_kernels(params, tiles, failures, oihw, lib53, libl)

    # int8 path: the demo weights quantized by the port's own calibration on
    # the card, the kernels' inputs taken from the int8 path itself
    res8 = SuperResolver(weights=weights, forward="pallas_int8", device="cuda")
    with torch.inference_mode():
        qp = res8._fwd_params()
    print(f"[chip_smoke] int8 calibration source: {res8.int8_calib_source}", flush=True)
    l53_names = ("conv_a1", "conv_a2", "conv_b1", "conv_b2")

    def i8_args(p, convs):
        return [p[c][k] for c in convs for k in ("q", "s", "bias")]

    with torch.inference_mode():
        x8 = torch.relu(_conv(tiles.to(torch.bfloat16), qp["level1"])).contiguous()
        h = x8
        for i in range(16):
            p = qp[f"body53_{i}"]
            h = ki8.light53_int8_plain(h, *i8_args(p, l53_names), p["act"])
        xl8 = h
        for i in range(6):
            p = qp[f"light_{i}"]
            h = ki8.light_int8_plain(h, *i8_args(p, ("conv_a", "conv_b")), p["act"])
        xu8 = h
        xh8 = upsample_phase_plain(xu8, 4).contiguous()
        # the uncalibrated tree (no "act": K4/K5 quantize every window
        # dynamically) and its own activations, by the plain dynamic blocks
        qd = didbl_pallas.quantize_didbl_params(params)
        xd = torch.relu(_conv(tiles.to(torch.bfloat16), qd["level1"])).contiguous()
        h = xd
        for i in range(16):
            h = ki8.light53_int8_dynamic_plain(h, *i8_args(qd[f"body53_{i}"], l53_names))
        xld = h
        for i in range(6):
            h = ki8.light_int8_dynamic_plain(h, *i8_args(qd[f"light_{i}"], ("conv_a", "conv_b")))
        xhd = upsample_phase_plain(h, 4).contiguous()
    del tiles, h
    p53, pl8, pt8 = qp["body53_0"], qp["light_0"], qp["tail53_0"]
    d53, dl8, dt8 = qd["body53_0"], qd["light_0"], qd["tail53_0"]
    x8f, xl8f = x8.float().contiguous(), xl8.float().contiguous()
    xdf, xldf = xd.float().contiguous(), xld.float().contiguous()
    i8_specs = [
        # name, kernel call, plain call, input, ops, peak, bytes, iters of the plain timing
        ("light53_int8",
         lambda x: ki8.light53_int8(x, *i8_args(p53, l53_names), act_scales=p53["act"]),
         lambda x: ki8.light53_int8_plain(x, *i8_args(p53, l53_names), p53["act"]),
         x8, 2.0 * 68 * c * c * x8[..., 0].numel(), PEAK_INT8_OPS,
         4.0 * x8.numel() + 68 * c * c, MIN_TIMED,
         "image_enhance_keras_tpu/ops/pallas/int8_blocks.py:263"),
        ("light_int8",
         lambda x: ki8.light_int8(x, *i8_args(pl8, ("conv_a", "conv_b")), act_scales=pl8["act"]),
         lambda x: ki8.light_int8_plain(x, *i8_args(pl8, ("conv_a", "conv_b")), pl8["act"]),
         xl8, 2.0 * 18 * c * c * xl8[..., 0].numel(), PEAK_INT8_OPS,
         4.0 * xl8.numel() + 18 * c * c, MIN_TIMED,
         "image_enhance_keras_tpu/ops/pallas/int8_blocks.py:335"),
        ("light53_int8_hr",
         lambda x: ki8.light53_int8(x, *i8_args(pt8, l53_names), act_scales=pt8["act"]),
         lambda x: ki8.light53_int8_plain(x, *i8_args(pt8, l53_names), pt8["act"]),
         xh8, 2.0 * 68 * c * c * xh8[..., 0].numel(), PEAK_INT8_OPS,
         4.0 * xh8.numel() + 68 * c * c, 3,
         "image_enhance_keras_tpu/ops/pallas/int8_blocks.py:263"),
        # the dynamic forms (act_scales=None, per-window scales over the
        # TPU's 48x96 windows at LR and 64x128 at HR) on the uncalibrated
        # path's inputs, and the float32-activation forms, static and dynamic
        ("light53_int8_dynamic",
         lambda x: ki8.light53_int8(x, *i8_args(d53, l53_names)),
         lambda x: ki8.light53_int8_dynamic_plain(x, *i8_args(d53, l53_names)),
         xd, 2.0 * 68 * c * c * xd[..., 0].numel(), PEAK_INT8_OPS,
         4.0 * xd.numel() + 68 * c * c, MIN_TIMED,
         "image_enhance_keras_tpu/ops/pallas/int8_blocks.py:263"),
        ("light53_int8_dynamic_hr",
         lambda x: ki8.light53_int8(x, *i8_args(dt8, l53_names)),
         lambda x: ki8.light53_int8_dynamic_plain(x, *i8_args(dt8, l53_names)),
         xhd, 2.0 * 68 * c * c * xhd[..., 0].numel(), PEAK_INT8_OPS,
         4.0 * xhd.numel() + 68 * c * c, 3,
         "image_enhance_keras_tpu/ops/pallas/int8_blocks.py:263"),
        ("light_int8_dynamic",
         lambda x: ki8.light_int8(x, *i8_args(dl8, ("conv_a", "conv_b"))),
         lambda x: ki8.light_int8_dynamic_plain(x, *i8_args(dl8, ("conv_a", "conv_b"))),
         xld, 2.0 * 18 * c * c * xld[..., 0].numel(), PEAK_INT8_OPS,
         4.0 * xld.numel() + 18 * c * c, MIN_TIMED,
         "image_enhance_keras_tpu/ops/pallas/int8_blocks.py:335"),
        ("light53_int8_f32",
         lambda x: ki8.light53_int8(x, *i8_args(p53, l53_names), act_scales=p53["act"]),
         lambda x: ki8.light53_int8_plain(x, *i8_args(p53, l53_names), p53["act"]),
         x8f, 2.0 * 68 * c * c * x8f[..., 0].numel(), PEAK_INT8_OPS,
         8.0 * x8f.numel() + 68 * c * c, MIN_TIMED,
         "image_enhance_keras_tpu/ops/pallas/int8_blocks.py:263"),
        ("light_int8_f32",
         lambda x: ki8.light_int8(x, *i8_args(pl8, ("conv_a", "conv_b")), act_scales=pl8["act"]),
         lambda x: ki8.light_int8_plain(x, *i8_args(pl8, ("conv_a", "conv_b")), pl8["act"]),
         xl8f, 2.0 * 18 * c * c * xl8f[..., 0].numel(), PEAK_INT8_OPS,
         8.0 * xl8f.numel() + 18 * c * c, MIN_TIMED,
         "image_enhance_keras_tpu/ops/pallas/int8_blocks.py:335"),
        ("light53_int8_dynamic_f32",
         lambda x: ki8.light53_int8(x, *i8_args(d53, l53_names)),
         lambda x: ki8.light53_int8_dynamic_plain(x, *i8_args(d53, l53_names)),
         xdf, 2.0 * 68 * c * c * xdf[..., 0].numel(), PEAK_INT8_OPS,
         8.0 * xdf.numel() + 68 * c * c, MIN_TIMED,
         "image_enhance_keras_tpu/ops/pallas/int8_blocks.py:263"),
        ("light_int8_dynamic_f32",
         lambda x: ki8.light_int8(x, *i8_args(dl8, ("conv_a", "conv_b"))),
         lambda x: ki8.light_int8_dynamic_plain(x, *i8_args(dl8, ("conv_a", "conv_b"))),
         xldf, 2.0 * 18 * c * c * xldf[..., 0].numel(), PEAK_INT8_OPS,
         8.0 * xldf.numel() + 18 * c * c, MIN_TIMED,
         "image_enhance_keras_tpu/ops/pallas/int8_blocks.py:335"),
        ("upsample_phase_tf1",
         lambda x: kup.upsample_phase_tf1_kernel(x, 4),
         lambda x: upsample_phase_plain(x, 4),
         xu8, 9.0 * 16 * xu8.numel(), PEAK_F32_FLOPS, 2.0 * 17 * xu8.numel(), MIN_TIMED,
         "image_enhance_keras_tpu/ops/pallas/upsample.py:94"),
        ("upsample_phase_tf1_f32",
         lambda x: kup.upsample_phase_tf1_kernel(x, 4),
         lambda x: upsample_phase_plain(x, 4),
         xu8.float().contiguous(), 9.0 * 16 * xu8.numel(), PEAK_F32_FLOPS,
         4.0 * 17 * xu8.numel(), MIN_TIMED,
         "image_enhance_keras_tpu/ops/pallas/upsample.py:94"),
    ]
    i8_rows = {}
    with torch.inference_mode():
        for name, kern, plain, x, ops, peak, nbytes, plain_iters, replaces in i8_specs:
            got, want = kern(x), plain(x)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            err = d.max().item()
            frac = (d > 0).float().mean().item()
            rel = err / max(want.float().abs().max().item(), 1e-30)
            exact = bool(torch.equal(got, want))
            if not exact:
                failures.append(f"{name}: kernel not bit-equal to plain (differ on {frac:.3g} of "
                                f"values, max |diff| {err:.3g} = {rel:.3g} of max|plain|)")
            ms = _time_ms(lambda: kern(x))
            plain_ms = _time_ms(lambda: plain(x), iters=plain_iters, warmup=1)
            bound_ms, bound_by = _bound(ops, peak, nbytes)
            i8_rows[name] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "max_abs_err": err, "bit_equal": exact, "shape": list(x.shape),
                "dtype": str(x.dtype).replace("torch.", ""), "replaces": replaces,
                "tops": ops / (ms * 1e-3) / 1e12,
            }
            print(f"[chip_smoke] {name} {tuple(x.shape)} {x.dtype}: bit-equal {exact}, max |diff| "
                  f"{err:.3g}, {ms:.4f} ms kernel, {plain_ms:.3f} ms plain, {bound_ms:.4f} ms bound "
                  f"({bound_by}), {ops / (ms * 1e-3) / 1e12:.2f} T(FL)OP/s", flush=True)
            if "int8" in name and not name.endswith("_f32"):
                # where a block's time goes, launch by launch (dynamic: abs-max, ring, second)
                i8_rows[name]["launch_ms"] = _launch_breakdown(lambda: kern(x))
                print(f"[chip_smoke]   {name} device ms per call by launch: "
                      f"{ {k: round(v, 4) for k, v in i8_rows[name]['launch_ms'].items()} }", flush=True)
        # K4 and K5 on ragged crops of the path's LR input (tiles of 64
        # columns and 4 rows cut by the image's edge)
        ragged_specs = [sp for sp in i8_specs if sp[0] in ("light53_int8", "light_int8", "light53_int8_dynamic",
                                                          "light_int8_dynamic")]
        for n_i, rh, rw in INT8_RAGGED:
            for name, kern, plain, *_ in ragged_specs:
                xr = (xd if "dynamic" in name else x8)[n_i:n_i + 1, :rh, :rw].contiguous()
                same = bool(torch.equal(kern(xr), plain(xr)))
                print(f"[chip_smoke] {name} ragged {tuple(xr.shape)}: bit-equal {same}", flush=True)
                if not same:
                    failures.append(f"{name} on a ragged {tuple(xr.shape)} input: not bit-equal to plain")
        # K3 (held bit-equal above): its bytes/s and share of the byte bound per
        # call and in device time; its first version's times are in PERF.md §6
        for name, xk in (("upsample_phase_tf1", xu8), ("upsample_phase_tf1_f32", xu8.float().contiguous())):
            row = i8_rows[name]
            nbytes = 17.0 * xk.numel() * xk.element_size()
            # the kernel's own device time (the per-call time holds the wrapper's host time)
            row["device_ms"] = _device_ms(lambda: kup.upsample_phase_tf1_kernel(xk, 4), row["bound_ms"])[0]
            if row["device_ms"] < row["bound_ms"]:
                failures.append(f"{name}: {row['device_ms']:.4f} ms device is below its byte bound")
            row["gbps"] = nbytes / (row["ms"] * 1e-3) / 1e9
            row["bound_share"] = row["bound_ms"] / row["ms"]
            print(f"[chip_smoke] {name} {tuple(xk.shape)}: {row['ms']:.4f} ms per call, {row['gbps']:.1f} GB/s, "
                  f"{row['bound_share']:.1%} of the byte bound {row['bound_ms']:.4f} ms; device time "
                  f"{row['device_ms']:.4f} ms, {nbytes / (row['device_ms'] * 1e-3) / 1e9:.1f} GB/s, "
                  f"{row['bound_ms'] / row['device_ms']:.1%} of the bound, on {gpu}", flush=True)
        # a yardstick, not the same function: cuDNN's bf16 convolutions of
        # the four Light53 convs (float weights) at the tail's shape
        xc = xh8.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        w4 = [oihw(params["tail53_0"][cv]["kernel"]).to(torch.bfloat16)
              .contiguous(memory_format=torch.channels_last) for cv in l53_names]

        def four_convs():
            for w in w4:
                F.conv2d(xc, w, padding=w.shape[-1] // 2)

        yard_ms = _time_ms(four_convs, iters=5, warmup=1)
        yard_ops = 2.0 * 68 * c * c * xh8[..., 0].numel()
        yardstick = {"what": "cuDNN bf16 F.conv2d, the four Light53 convs (no quantization, no "
                             "epilogue)", "shape": list(xh8.shape), "ms": yard_ms,
                     "tflops": yard_ops / (yard_ms * 1e-3) / 1e12}
        print(f"[chip_smoke] yardstick: cuDNN bf16 F.conv2d of the four Light53 convs at "
              f"{tuple(xh8.shape)}: {yard_ms:.4f} ms, {yardstick['tflops']:.1f} TFLOP/s "
              f"(K4 at this shape {i8_rows['light53_int8_hr']['ms']:.4f} ms) on {gpu}", flush=True)
        del xc, w4
    # the XLA int8 forms (X1-X3) on the int8 forward's own activations
    rows += _int8_xla_kernels(qp, x8, sass["int8_blocks"], sass["int8_conv"], failures, gpu)
    del x8, xl8, xu8, xh8, xd, xld, xhd, x8f, xl8f, xdf, xldf
    up32 = i8_rows.pop("upsample_phase_tf1_f32")
    hrs = {"light53_int8": i8_rows.pop("light53_int8_hr"),
           "light53_int8_dynamic": i8_rows.pop("light53_int8_dynamic_hr")}
    fns8 = (sass["int8_blocks"] or {}).get("functions", {})
    for name, row in i8_rows.items():
        if "int8" in name:
            row["sass_gmma"] = _gmma_lines(fns8, name)
            print(f"[chip_smoke] {name}: {row['sass_gmma']} GMMA lines in its kernel functions", flush=True)
            if row["sass_gmma"] == 0:
                failures.append(f"{name}: no GMMA (wgmma) line in the SASS of its kernel functions")
    # the float32-activation forms of K4/K5 go on the rows of their bf16
    # forms (f32_* keys), as K3's float32 form does: no path launches them
    f32s = {name[:-4]: i8_rows.pop(name) for name in [n for n in i8_rows if n.endswith("_f32")]}
    for name, row in i8_rows.items():
        extra = {}
        if name in hrs:
            extra = {f"hr_{k}": hrs[name][k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err", "shape",
                                                        "bit_equal", "tops", "launch_ms")}
        for k in ("launch_ms", "sass_gmma"):
            if k in row:
                extra[k] = row[k]
        if name in f32s:
            extra.update({f"f32_{k}": f32s[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                              "max_abs_err", "bit_equal", "tops", "sass_gmma")})
            extra["f32_name"] = f"{name}_f32"
        if name == "upsample_phase_tf1":
            keys = ("device_ms", "gbps", "bound_share")
            extra = {f"f32_{k}": up32[k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err") + keys}
            extra.update({k: row[k] for k in keys})
        rows.append({
            "name": name, "route": "cuda",
            "source": "image_enhance_keras_tpu_torch/csrc/"
                      + ("upsample.cu" if name.startswith("upsample") else "int8_blocks.cu"),
            "replaces": row["replaces"], "launches": None, "max_abs_err": row["max_abs_err"],
            "tolerance": 0.0, "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None, "shape": row["shape"],
            "dtype": row["dtype"], "bit_equal": row["bit_equal"], "tops": row["tops"], **extra,
        })
    _phase("2 kernels", t0)

    # -- 3. the main path ----------------------------------------------------
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="iek_chip_smoke_")
    try:
        dirs = {f: os.path.join(tmp, f) for f in ("pallas", "xla")}
        for d in dirs.values():
            os.makedirs(d)
            imwrite(os.path.join(d, "img.bmp"), img)
        kb.fused_light53_block.launches = 0
        kb.fused_light_block.launches = 0
        torch.cuda.synchronize()
        t1 = time.time()
        rc = main_dirpath.main([dirs["pallas"], "--forward", "pallas"])
        torch.cuda.synchronize()
        cli_s = time.time() - t1
        launches = {"light53_block": kb.fused_light53_block.launches,
                    "light_block": kb.fused_light_block.launches}
        print(f"[chip_smoke] main_dirpath --forward pallas: rc {rc}, {cli_s:.2f} s, launches {launches}",
              flush=True)
        for row in rows:
            if row["name"] in launches:
                row["launches"] = launches[row["name"]]
        if rc != 0:
            failures.append(f"main_dirpath --forward pallas returned {rc}")
        if launches != {"light53_block": 16, "light_block": 6}:
            failures.append(f"kernel launches on the main path {launches} != 16 Light53 + 6 Light")
        out_p = imread(os.path.join(dirs["pallas"], "img_scaled(1x).bmp"))
        if out_p.shape != (512, 512, 3):
            failures.append(f"pallas output shape {out_p.shape} != (512, 512, 3)")

        rc = main_dirpath.main([dirs["xla"], "--forward", "xla", "--suffix", "xla"])
        out_x = imread(os.path.join(dirs["xla"], "img_xla(1x).bmp"))
        if rc != 0 or out_x.shape != out_p.shape:
            failures.append(f"main_dirpath --forward xla: rc {rc}, shape {out_x.shape}")
        else:
            dmax, frac = _u8_agreement(out_p, out_x)
            print(f"[chip_smoke] pallas vs xla uint8: max diff {dmax}, differing fraction {frac:.3g} "
                  f"(bound {U8_MAX_DIFF} on {U8_MAX_FRAC})", flush=True)
            if dmax > U8_MAX_DIFF or frac > U8_MAX_FRAC:
                failures.append(f"pallas vs xla outputs differ: max {dmax}, fraction {frac:.3g}")
        if float(out_p.astype(np.float64).std()) < 1.0:
            failures.append("pallas output is flat")

        # the chain path: one K6 and one K7 launch for the one chunk of 9 tiles
        d = os.path.join(tmp, "pallas_chain")
        os.makedirs(d)
        imwrite(os.path.join(d, "img.bmp"), img)
        counted = (kb.fused_light53_block, kb.fused_light_block, kt.fused_light53_chain, kt.fused_light_chain)
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        t1 = time.time()
        rc = main_dirpath.main([d, "--forward", "pallas_chain"])
        torch.cuda.synchronize()
        cli_s = time.time() - t1
        launches_c = dict(zip(("light53_block", "light_block", "light53_chain", "light_chain"),
                              (fn.launches for fn in counted)))
        print(f"[chip_smoke] main_dirpath --forward pallas_chain: rc {rc}, {cli_s:.2f} s, "
              f"launches {launches_c}", flush=True)
        for row in rows:
            if row["name"] in ("light53_chain", "light_chain"):
                row["launches"] = launches_c[row["name"]]
        if rc != 0:
            failures.append(f"main_dirpath --forward pallas_chain returned {rc}")
        want_c = {"light53_block": 0, "light_block": 0, "light53_chain": 1, "light_chain": 1}
        if launches_c != want_c:
            failures.append(f"pallas_chain launches {launches_c} != {want_c}")
        out_c = imread(os.path.join(d, "img_scaled(1x).bmp"))
        for ref_name, ref in (("pallas", out_p), ("xla", out_x)):
            if out_c.shape != ref.shape:
                failures.append(f"pallas_chain output shape {out_c.shape} != {ref_name}'s {ref.shape}")
                continue
            dmax, frac = _u8_agreement(out_c, ref)
            print(f"[chip_smoke] pallas_chain vs {ref_name} uint8: max diff {dmax}, differing fraction "
                  f"{frac:.3g} (bound {U8_MAX_DIFF} on {U8_MAX_FRAC})", flush=True)
            if dmax > U8_MAX_DIFF or frac > U8_MAX_FRAC:
                failures.append(f"pallas_chain vs {ref_name} outputs differ: max {dmax}, fraction {frac:.3g}")
        _phase("3a pallas, pallas_chain and xla paths (CLI)", t0)

        # the bf16 profile through the CLI, with the plain bf16 versions swapped in as its reference
        t0 = time.time()
        out_bf16: dict = {}
        bf16_cli = _bf16_cli(tmp, img, out_p, failures, rows, out_bf16)
        _phase("3a bf16 pallas and pallas_chain paths (CLI)", t0)

        # the int8 path: calibration, quantization and the forward, all in the
        # CLI run; K3 takes the x4 (one launch in calibration, one per chunk of
        # tiles).  Then the same run with the plain x4 in place of K3, and
        # with the plain int8 blocks in place of K4 and K5: each must give the
        # same bytes (their launches are not the main path's).
        t0 = time.time()

        outs8 = {}
        for up in ("kernel", "plain_x4", "plain_blocks"):
            d = os.path.join(tmp, f"int8_{up}")
            os.makedirs(d)
            imwrite(os.path.join(d, "img.bmp"), img)
            _zero_counts()
            with _Swapped(up):
                torch.cuda.synchronize()
                t1 = time.time()
                rc = main_dirpath.main([d, "--forward", "pallas_int8"])
                torch.cuda.synchronize()
                cli_s = time.time() - t1
            launches8 = {"light53_int8": ki8.light53_int8.launches,
                         "light_int8": ki8.light_int8.launches,
                         "upsample_phase_tf1": kup.upsample_phase_tf1_kernel.launches}
            print(f"[chip_smoke] main_dirpath --forward pallas_int8, {up}: rc {rc}, "
                  f"{cli_s:.2f} s (calibration included), launches {launches8}", flush=True)
            want8 = {"light53_int8": 0 if up == "plain_blocks" else 18,
                     "light_int8": 0 if up == "plain_blocks" else 6,
                     "upsample_phase_tf1": 0 if up == "plain_x4" else 2}
            if rc != 0:
                failures.append(f"main_dirpath --forward pallas_int8 ({up}) returned {rc}")
            if launches8 != want8:
                failures.append(f"int8 path launches {launches8} != {want8}")
            if up == "kernel":
                for row in rows:
                    if row["name"] in launches8:
                        row["launches"] = launches8[row["name"]]
            outs8[up] = imread(os.path.join(d, "img_scaled(1x).bmp"))
        out_8 = outs8["kernel"]
        if out_8.shape != (512, 512, 3) or float(out_8.astype(np.float64).std()) < 1.0:
            failures.append(f"int8 output shape {out_8.shape} or flat")
        same8 = {}
        for other in ("plain_x4", "plain_blocks"):
            same8[other] = bool(np.array_equal(outs8["kernel"], outs8[other]))
            if not same8[other]:
                dmax, frac = _u8_agreement(outs8["kernel"], outs8[other])
                failures.append(f"int8 outputs of the kernels and of the {other} run differ: "
                                f"max {dmax}, fraction {frac:.3g}")
        psnr8 = _psnr(out_8, out_p)
        dmax, frac = _u8_agreement(out_8, out_p)
        print(f"[chip_smoke] int8 output of the kernels byte-equal with the plain x4 "
              f"{same8['plain_x4']}, with the plain int8 blocks {same8['plain_blocks']}; "
              f"PSNR of int8 against the float32 pallas "
              f"output {psnr8:.2f} dB (max diff {dmax}, differing fraction {frac:.3g})", flush=True)
        if psnr8 < 30.0:
            failures.append(f"int8 output is far from the float32 output: PSNR {psnr8:.2f} dB")
        _phase("3a' pallas_int8 path (CLI)", t0)

        # --forward int8, the XLA int8 serving profile, on X1/X2 and K3
        t0 = time.time()
        int8_cli = _int8_xla_cli(tmp, img, out_p, out_8, failures, rows)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _phase("3e --forward int8 path (CLI)", t0)

    # the mixed profiles through the CLI
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="iek_chip_smoke_mixed_")
    try:
        mixed_cli = _mixed_cli(tmp, img, weights, out_bf16, out_8, failures)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _phase("3a''' mixed profiles (CLI) and CPU references", t0)

    # split mode: stripes and 2-D tiles against fast, on xla float32 / bf16 and pallas_int8
    t0 = time.time()
    split = _split_phase(weights, qp, failures, gpu)
    for row in rows:  # X3 runs on the int8 forward's dynamic tail (3c's int8_dynamic_tail run)
        if row["name"] == "light53_int8_xla_dyn":
            row["launches"] = split["int8 int8_dynamic_tail"]["launches"].get("light53_int8_xla_dyn", 0)
    _phase(f"3c split and split2d at {SPLIT_HW}x{SPLIT_HW}", t0)
    t0 = time.time()
    extras = _extras_phase(weights, img, failures)
    _phase("3d self-ensemble and back-projection", t0)

    # the uncalibrated int8 forward through the library API (no engine path
    # reaches it: the engine always calibrates)
    t0 = time.time()
    uncal = _uncalibrated_phase(params, qp, img, plan, failures, rows, gpu)
    _phase("3a'' uncalibrated int8 forward (apply_didbl_int8, dynamic scales)", t0)

    # timing of the engine alone (weights loaded once), in turns, and a CPU
    # reference on a crop (plain torch on the CPU, no CUDA kernel involved)
    t0 = time.time()
    res = {f: SuperResolver(weights=weights, forward=f, device="cuda") for f in ("pallas", "pallas_chain", "xla")}
    res["pallas_int8"] = res8  # weights quantized in phase 2
    res["int8"] = SuperResolver(weights=weights, forward="int8", device="cuda")
    res["int8"]._qparams = qp  # the same calibration and quantization as --forward int8's
    for f in ("pallas", "pallas_chain", "xla"):
        res[f"{f} --dtype bfloat16"] = SuperResolver(weights=weights, forward=f, dtype=torch.bfloat16,
                                                     device="cuda")
    secs = {f: [] for f in res}
    order = tuple(res)
    for f in order + order[::-1]:
        torch.cuda.synchronize()
        t1 = time.time()
        res[f].upscale(img)
        torch.cuda.synchronize()
        secs[f].append(time.time() - t1)
    mpix = 512 * 512 / 1e6
    for f, s in secs.items():
        print(f"[chip_smoke] engine --forward {f}, 128x128 -> 512x512 patch mode: "
              f"{min(s):.3f} s, {mpix / min(s):.3f} out-Mpix/s on {gpu}", flush=True)
    # the bf16 forwards' device time by kernel and idle share, under torch.profiler
    from image_enhance_keras_tpu_torch.utils.profiling import profile_upscale

    bf16_profile = {}
    for f in ("pallas", "pallas_chain", "xla"):
        wall, prof_rows = profile_upscale(res[f"{f} --dtype bfloat16"], img, 3)
        busy = sum(ms for _, ms, _ in prof_rows) / 3
        idle = max(0.0, 1.0 - busy / (wall * 1e3))
        bf16_profile[f] = {"wall_ms": wall * 1e3, "device_ms": busy, "idle_share": idle,
                           "kernels": [(name[:90], ms / 3, calls // 3) for name, ms, calls in prof_rows[:10]]}
        print(f"[chip_smoke] profile --forward {f} --dtype bfloat16, 128x128 patch mode: {wall * 1e3:.3f} ms "
              f"wall, {busy:.3f} ms device, idle share {idle:.3f} on {gpu}", flush=True)
        for name, ms, calls in bf16_profile[f]["kernels"]:
            print(f"[chip_smoke]   {ms:9.3f} ms {100 * ms / busy:5.1f}% {calls:4d} calls  {name}", flush=True)
    # the int8 forwards' device time by kernel and idle share, in the same call
    int8_profile = {}
    for f in ("int8", "pallas_int8"):
        wall, prof_rows = profile_upscale(res[f], img, 3)
        busy = sum(ms for _, ms, _ in prof_rows) / 3
        idle = max(0.0, 1.0 - busy / (wall * 1e3))
        int8_profile[f] = {"wall_ms": wall * 1e3, "device_ms": busy, "idle_share": idle,
                           "kernels": [(name[:90], ms / 3, calls // 3) for name, ms, calls in prof_rows[:12]]}
        print(f"[chip_smoke] profile --forward {f}, 128x128 patch mode: {wall * 1e3:.3f} ms wall, {busy:.3f} ms "
              f"device, idle share {idle:.3f} on {gpu}", flush=True)
        for name, ms, calls in int8_profile[f]["kernels"]:
            print(f"[chip_smoke]   {ms:9.3f} ms {100 * ms / busy:5.1f}% {calls:4d} calls  {name}", flush=True)
    crop = np.ascontiguousarray(img[:20, :24])
    ref = SuperResolver(weights=weights, forward="xla", mode="fast", device="cpu").upscale(crop)
    for f in ("pallas", "pallas_chain"):
        got = SuperResolver(weights=weights, forward=f, mode="fast", device="cuda").upscale(crop)
        dmax, frac = _u8_agreement(got, ref)
        print(f"[chip_smoke] fast mode 20x24 crop, card {f} vs cpu xla: max diff {dmax}, "
              f"differing fraction {frac:.3g}", flush=True)
        if dmax > U8_MAX_DIFF or frac > U8_MAX_FRAC:
            failures.append(f"card {f} vs CPU reference differ: max {dmax}, fraction {frac:.3g}")
    # the int8 forward on the CPU with the card's quantized tree (no CPU
    # calibration at full width)
    cpu8 = SuperResolver(weights=weights, forward="pallas_int8", mode="fast", device="cpu")
    cpu8._qparams = _tree_to(qp, "cpu")
    card8 = SuperResolver(weights=weights, forward="pallas_int8", mode="fast", device="cuda")
    card8._qparams = qp
    dmax, frac = _u8_agreement(card8.upscale(crop), cpu8.upscale(crop))
    print(f"[chip_smoke] fast mode 20x24 crop, card pallas_int8 vs cpu pallas_int8 (card's quantized "
          f"tree): max diff {dmax}, differing fraction {frac:.3g} (bound {INT8_U8_MAX_DIFF} on under "
          f"{INT8_U8_MAX_FRAC})", flush=True)
    if dmax > INT8_U8_MAX_DIFF or frac >= INT8_U8_MAX_FRAC:
        failures.append(f"int8 card vs CPU reference differ: max {dmax}, fraction {frac:.3g}")
    # the int8 forward on the CPU (the plain X blocks) with the card's quantized tree
    cpux = SuperResolver(weights=weights, forward="int8", mode="fast", device="cpu")
    cpux._qparams = _tree_to(qp, "cpu")
    cardx = SuperResolver(weights=weights, forward="int8", mode="fast", device="cuda")
    cardx._qparams = qp
    # (the bf16 level1 / out convs are cuDNN's on the card and float32 sums rounded once on the CPU)
    dmax, frac = _u8_agreement(cardx.upscale(crop), cpux.upscale(crop))
    print(f"[chip_smoke] fast mode 20x24 crop, card int8 vs cpu int8 (card's quantized tree): max diff "
          f"{dmax}, differing fraction {frac:.3g} (bound {INT8_U8_MAX_DIFF} on under {INT8_U8_MAX_FRAC})",
          flush=True)
    if dmax > INT8_U8_MAX_DIFF or frac >= INT8_U8_MAX_FRAC:
        failures.append(f"int8 (XLA form) card vs CPU reference differ: max {dmax}, fraction {frac:.3g}")
    _phase("3b engine timing and CPU references", t0)

    # -- 4. Set5 scoring ------------------------------------------------------
    t0 = time.time()
    set5 = _set5_phase(failures)
    _phase("4 Set5 scoring", t0)

    # -- 5. the rest of the zoo --------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="iek_chip_smoke_zoo_")
    try:
        zoo = _zoo_phase(tmp, img, failures, rows, sass.get("int8_conv"), gpu)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 6. training ----------------------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="iek_chip_smoke_train_")
    try:
        train = _train_phase(tmp, img, failures, rows, gpu)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 7. the serving runtime -------------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="iek_chip_smoke_serve_")
    try:
        serve = _serving_phase(tmp, img, failures, gpu)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 8. scale-out -----------------------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="iek_chip_smoke_scale_")
    try:
        scale_out = _scale_out_phase(tmp, failures, gpu)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 9. the long tail: compat, the int8 knobs, the ops tail --------------------------
    tmp = tempfile.mkdtemp(prefix="iek_chip_smoke_tail_")
    try:
        long_tail = _long_tail_phase(tmp, qp, failures, rows, gpu)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _phase("total", t_all)

    if failures:
        for f in failures:
            print(f"[chip_smoke] FAIL: {f}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"kernels": rows, "build_s": build_s, "card": gpu, "int8_yardstick": yardstick,
                      "sass": sass,
                      "int8_calib_source": res8.int8_calib_source, "int8_psnr_vs_f32": psnr8,
                      "int8_uncalibrated": uncal,
                      "engine_s_per_image": {f: min(v) for f, v in secs.items()},
                      "bf16_profile": bf16_profile, "bf16_cli": bf16_cli, "mixed_cli": mixed_cli,
                      "split": split, "extras": extras, "int8_cli": int8_cli, "int8_profile": int8_profile,
                      "set5": set5, "zoo": zoo, "train": train, "serving": serve,
                      "scale_out": scale_out, "long_tail": long_tail}),
          flush=True)
    print(_gpu_name_power(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--nccl-child"]:  # phase 8c's ranks
        sys.exit(_nccl_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
