"""Time the scan-search kernel (K10) and its prefix rebuild on one card.

    python3 tools/scan_beam_time.py [--reps N] [--source FILE]

At the served shape (B=128 utterances, T'=499 frames, C=64 classes, beam
K=8, max_len 256, seeded log-probs with ragged lengths as chip_smoke's) on
the bench LG (bench.py:183-201, 58,272 states), for class_topk 8 and 63:
the kernel's ms from CUDA events (mean of --reps calls after a warm-up),
the mean SM clock cycles a frame by part as thread 0 of each block sees
them (the kernel's clock sums), and the SM clock that nvidia-smi reads;
then class_topk 8 at B = 1, 32, 64 and 128 (whether blocks share an SM),
and the rebuild's ms. --source builds FILE (another version of
csrc/scan_beam.cu with the same C interface) beside the package's and
times the two in turns at class_topk 8 and 63 (package, source, source,
package, package, source), each call's results checked equal to the
package's. Prints the card's name and power limit first. Needs one CUDA
card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from tpuasr_torch import _build  # noqa: E402
from tpuasr_torch.decode import BeamSearchConfig, beam_init_state  # noqa: E402
from tpuasr_torch.decode import prefix_beam as pbm  # noqa: E402
from tpuasr_torch.features import FeatureConfig  # noqa: E402
from tpuasr_torch.features.reference import num_frames  # noqa: E402


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--source", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(smi("name,power.limit"), flush=True)
    _build.lib()
    dev = torch.device("cuda")
    tabs, _, _ = cs.bench_graph()
    g_pack = torch.cat([torch.as_tensor(tabs.next_state),
                        torch.as_tensor(tabs.cost).view(torch.int32)],
                       1).to(dev).contiguous()
    T = -(-num_frames(FeatureConfig(), int(cs.SR * cs.SECONDS)) // 2)
    gen = torch.Generator().manual_seed(cs.SEED)
    lp = torch.log_softmax(torch.randn(cs.B, T, cs.NUM_CLASSES,
                                       generator=gen) * 2.0, -1)
    lp = lp.to(dev).contiguous()
    lens = torch.randint(1, T + 1, (cs.B,), generator=gen).to(torch.int32)
    lens[0], lens[1], lens[2] = T, 0, 1
    lens = lens.to(dev)
    K, L = cs.BEAM, 256

    def args_for(B, P):
        cfg = BeamSearchConfig(beam_width=K, class_topk=P, max_len=L)
        state = dict(beam_init_state(B, cfg, dev),
                     last2=torch.full((B, K), -1, dtype=torch.int32,
                                      device=dev),
                     gs=torch.full((B, K), tabs.start, dtype=torch.int32,
                                   device=dev),
                     gc=torch.zeros((B, K), device=dev))
        return (lp[:B].contiguous(), lens[:B].contiguous(), state, K, P, 0, L,
                None, 0, 0.0, g_pack, 1.0)

    for P in (8, cs.NUM_CLASSES - 1):
        a = args_for(cs.B, P)
        ms = cs.cuda_ms(lambda: pbm.scan_search(*a), args.reps)
        clocks = torch.zeros((cs.B, len(pbm.CLOCK_PARTS)), dtype=torch.int64,
                             device=dev)
        pbm.scan_search(*a, clocks=clocks)
        clk = smi("clocks.sm")
        torch.cuda.synchronize()
        frames = max(int(lens.clamp(0, T).sum()), 1)
        per = (clocks.sum(0).double() / frames).tolist()
        parts = ", ".join(f"{n} {v:.0f}" for n, v in
                          zip(pbm.CLOCK_PARTS, per))
        print(f"K10 B={cs.B} T={T} C={cs.NUM_CLASSES} K={K} P={P} "
              f"({32 * K} threads a block): {ms:.4f} ms "
              f"({ms / T * 1e3:.2f} us a frame); SM cycles a frame: {parts};"
              f" sum {sum(per):.0f} (SM clock {clk})", flush=True)
    row = []
    for B in (1, 32, 64, 128):
        a = args_for(B, 8)
        ms = cs.cuda_ms(lambda: pbm.scan_search(*a), args.reps)
        row.append(f"B={B} {ms:.4f}")
    print("K10 P=8 by batch, ms: " + "; ".join(row), flush=True)
    bp, _ = pbm.scan_search(*args_for(cs.B, 8))
    base = torch.full((cs.B, K, L), -1, dtype=torch.int32, device=dev)
    plen = torch.zeros((cs.B, K), dtype=torch.int32, device=dev)
    rb = cs.queued_ms(lambda: pbm.rebuild_prefixes(bp, base, plen, L), 20)
    print(f"K10-rebuild B={cs.B} T={T} K={K}: {rb:.4f} ms", flush=True)
    if args.source:
        in_turns(Path(args.source), args_for, args.reps)
    return 0


def in_turns(source: Path, args_for, reps: int) -> None:
    """The package's kernel and the one built from source, in turns."""
    pkg = _build.lib()
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "scan_beam_source.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
               str(source), str(_build.CSRC_DIR / "common.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed\n{res.stderr}")
        other = ctypes.CDLL(str(so))
        other.tpuasr_error_string.argtypes = [ctypes.c_int]
        other.tpuasr_error_string.restype = ctypes.c_char_p
        want = {P: pbm.scan_search(*args_for(cs.B, P))
                for P in (8, cs.NUM_CLASSES - 1)}
        for turn in ("package", "source", "source", "package", "package",
                     "source"):
            row = []
            with mock.patch.object(_build, "_lib",
                                   other if turn == "source" else pkg):
                for P, (wbp, wst) in want.items():
                    a = args_for(cs.B, P)
                    bp, st = pbm.scan_search(*a)
                    same = torch.equal(bp, wbp) and all(
                        torch.equal(st[k], wst[k]) for k in wst)
                    ms = cs.cuda_ms(lambda: pbm.scan_search(*a), reps)
                    row.append(f"P={P} {ms:.4f} ms (equal {same})")
            name = source.name if turn == "source" else "csrc/scan_beam.cu"
            print(f"K10 in turns, {turn} ({name}): " + "; ".join(row),
                  flush=True)


if __name__ == "__main__":
    sys.exit(main())
