"""Where K9's time goes (csrc/conv_q8.cu, the int8 conv2), on one card.

    python3 tools/conv_q8_parts.py [--source PATH]

Builds a conv_q8.cu (by default the package's own; --source takes another
copy, e.g. an older commit's unpacked with git archive) as it is and in
ablated copies, each with one part of the main loop taken out:

  no quantize   the int8 A tiles are left as they are (im2col quantizes
                inside the loop; an older source quantizes in every body);
  no mma        the tensor-core products (mma.sync, wgmma) are not issued;
  no barriers   the block-wide barriers of the main loop are not taken;
  mma only      the products alone: no quantizing, barriers, copies or
                waits for them (the pre-passes still run);

  im2col 128x256  not an ablation: im2col's block at 128 rows x 256
                columns (each value quantized for each of two column tiles,
                the band matrix read from L2 half as often) in place of
                64 x 512;

and times each build's three bodies (im2col, taps, slab; CUDA events, mean
of 10 after one warm-up) at conv2's shapes in the served model: B=128,
T_out=499, Kt=11, Kd=1024, N=512. An ablated build computes wrong values:
its time only says what the part costs. A part that a source does not have
(the pre-quantized bodies have no quantize phase in their loop) is timed as
it is. Prints the card's name and power limit first. Needs one CUDA card
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tpuasr_torch import _build  # noqa: E402

CSRC = ROOT / "tpuasr_torch" / "csrc"
MODES = ("im2col", "taps", "slab")
# name -> [(text in conv_q8.cu, replacement)]: every pair whose text occurs
# is applied (the older and the current source mark their parts apart).
NO_QUANTIZE = [
    # the older source: the quantize loop of every body
    ("for (int e = tid; e < kBM * (kKC / 4); e += kThreads) {",
     "for (int e = tid; e < 0; e += kThreads) {"),
    # the current source: im2col's quantize of the next A tile
    ("if (j >= n_steps) return;", "return;"),
]
NO_BARRIERS = [("__syncthreads();", ";")]
NO_COPIES = [
    ('"cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"', '""'),
    ('"cp.async.wait_group 1;\\n"', '""'),
    ('"cp.async.wait_group %0;\\n"', '""'),
]
ABLATIONS = {
    "as is": [],
    "no quantize": NO_QUANTIZE,
    "no mma": [
        ("mma_s8(acc[mi][ni], af_[mi], bf[ni]);", "(void)bf;"),
        ("wgmma_n256(acc, da, db);", "(void)db;"),
        ("wgmma_n128(acc, da, db);", "(void)db;"),
    ],
    "no barriers": NO_BARRIERS,
    "mma only": NO_QUANTIZE + NO_BARRIERS + NO_COPIES,
    "im2col 128x256": [
        ("static constexpr int BM = M == kIm2col ? 64 : 128;",
         "static constexpr int BM = 128;"),
        ("static constexpr int BN = M == kIm2col ? 512 : M == kTaps ? 128 "
         ": 256;", "static constexpr int BN = M == kTaps ? 128 : 256;"),
    ],
}


def build(name: str, src_text: str, edits, out: Path) -> ctypes.CDLL:
    src = src_text
    for old, new in edits:
        src = src.replace(old, new)
    if edits and src == src_text:
        print(f"{name}: no such part in this source, built as is",
              flush=True)
    d = out / name.replace(" ", "_")
    d.mkdir()
    (d / "conv_q8.cu").write_text(src)
    so = d / "lib.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
           str(d / "conv_q8.cu"), str(CSRC / "common.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stderr}")
    return ctypes.CDLL(str(so))


def caller(lib, xf, mqt, sw, out, T_out, mode):
    """A call of the library's tpuasr_conv_q8 with the scratch its source
    asks for (tpuasr_conv_q8_scratch where it has one, else the older
    source's (B, T_rm) row absmaxes)."""
    B, T_in, Kd = xf.shape
    Kt, N, _ = mqt.shape
    mi = MODES.index(mode)
    if hasattr(lib, "tpuasr_conv_q8_scratch"):
        q = lib.tpuasr_conv_q8_scratch
        q.argtypes = [ctypes.c_int] * 7
        q.restype = ctypes.c_longlong
        n = q(B, T_in, T_out, Kt, Kd, N, mi)
    else:
        n = 4 * B * (-(-T_out // 128) * 128 + Kt - 1)
    scratch = torch.empty(max(n, 16), dtype=torch.uint8, device="cuda")
    fn = lib.tpuasr_conv_q8
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = [_build.ptr(t) for t in (xf, mqt, sw, scratch, out)]

    def call():
        code = fn(*args, B, T_in, T_out, Kt, Kd, N, mi,
                  _build.stream_ptr(xf))
        if code != 0:
            raise RuntimeError(f"tpuasr_conv_q8 ({mode}): CUDA error {code}")

    return call


def ms_of(call, iters: int = 10) -> float:
    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", type=Path, default=CSRC / "conv_q8.cu",
                    help="the conv_q8.cu to ablate (default: the package's)")
    ap.add_argument("--modes", nargs="+", choices=MODES, default=MODES,
                    help="the bodies to time (default: all three)")
    ap.add_argument("--parts", nargs="+", choices=list(ABLATIONS),
                    default=list(ABLATIONS),
                    help="the builds to time (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"source: {args.source}", flush=True)
    B, T_out, Kt, Kd, N = 128, 499, 11, 1024, 512
    g = torch.Generator().manual_seed(0)
    xf = torch.relu(torch.randn(B, T_out + Kt - 1, Kd, generator=g)).cuda()
    mqt = torch.randint(-127, 128, (Kt, N, Kd), generator=g).to(
        torch.int8).cuda()
    sw = (torch.rand(N, generator=g) * 1e-3).cuda()
    out = torch.empty(B, T_out, N, device="cuda")
    text = args.source.read_text()
    with tempfile.TemporaryDirectory() as tmp:
        parts = {k: ABLATIONS[k] for k in args.parts}
        with ThreadPoolExecutor(len(parts)) as pool:
            libs = dict(zip(parts, pool.map(
                lambda kv: build(kv[0], text, kv[1], Path(tmp)),
                parts.items())))
        for mode in args.modes:
            row = []
            for name, lib in libs.items():
                ms = ms_of(caller(lib, xf, mqt, sw, out, T_out, mode))
                row.append(f"{name} {ms:.3f} ms")
            print(f"{mode}: " + "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
