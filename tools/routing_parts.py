"""Where K8 (capsule routing, forward) and K8b (its backward) spend their
time, on one card.

    python3 tools/routing_parts.py [--source FILE] [--parent DIR] [--ptxas]
                                   [--clusters] [--pr13 DIR]

Prints the card's name and power limit first. Then, at config 4's shapes
(I=256 capsules, Din=8, O=48 classes, D=16, 3 iterations, B=8 and B=32
utterances of T'=249 frames):
  * builds csrc/routing.cu (or --source, another version of it) with
    csrc/routing_bwd.cu and TPUASR_ROUTING_CLOCKS, which makes thread 0 of
    each CTA sum the SM clock cycles of each phase, and prints the mean
    cycles a capsule step by phase (u_hat with its wait for the stage and
    its release; b, the group barrier, parking u_hat with the softmax, each
    a routed step's; the s update) and
    an iteration's cluster steps (the partial s to shared memory, the
    cluster's sum, squash and all-gather, two cluster barriers), with the
    kernel's time from CUDA events (the counters cost a few cycles a
    phase) and the SM clock nvidia-smi reads meanwhile;
  * times K8 (mean of 10 calls, CUDA events) at 3 iterations and at 1 (no
    routing), and in its saving mode, and K8b's launches apart: the ds
    pass, pass 2 and the chunk sum (the same build's
    tpuasr_routing_bwd_passes selects them);
  * with --clusters, times K8 with clusters of 2, 1, 4 and 8 CTAs (the
    plan otherwise unchanged), with the clusters the card holds at once;
  * with --parent DIR (a checkout of another commit), runs DIR's and this
    tree's routed_caps and K8b in turns in fresh processes (parent,
    change, change, parent): K8, K8b as the train step runs it, and
    routed_caps_bwd from (u, W, dv); and config 4's train step through
    Trainer (capsule1, 48 classes, adamw, W_route scaled by 20 as in
    chip_smoke.py; B=8 and 32 x 5 s, U=16; mean of 10 steps after two, CUDA
    events around the steps, so host time shows where it exceeds the
    device's).
--ptxas prints what ptxas reports for the routing kernels (registers,
spills). --pr13 DIR takes PR 13's kernels apart instead (DIR a checkout of
that commit, `f58fe97`): a copy of its csrc/routing.cu with counters
patched around the phases of a chunk of 2 capsules (u_hat; b; the two
barriers with the softmax and the next chunk's loads; s), and of
csrc/routing_bwd.cu with a switch over its three passes (pass 1: K8
writing V and ds; pass 2; the chunk sum), each timed apart. Needs one CUDA
card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "tpuasr_torch" / "csrc"
I, DIN, O, D, ITERS, T = 256, 8, 48, 16, 3, 249
PHASES = ("u_hat (with its wait and release)", "b", "group barrier",
          "park u_hat + softmax", "s")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def sm_clock() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def cuda_ms(fn, n=10):
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def inputs(rm, Bc, seed=0):
    """config 4's routing inputs as chip_smoke.py makes them."""
    g = torch.Generator().manual_seed(seed)
    u = rm.squash(torch.randn(Bc, T, I, DIN, generator=g) * 2.0)
    W = torch.randn(I, DIN, O * D, generator=g) * 0.5
    dv = torch.randn(Bc, T, O, D, generator=g)
    return u.cuda().contiguous(), W.cuda().contiguous(), dv.cuda()


def build(source: Path, out: Path, ptxas: bool) -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT))
    from tpuasr_torch import _build
    so = out / "routing_clocks.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-DTPUASR_ROUTING_CLOCKS",
           *(["-Xptxas", "-v"] if ptxas else []), "-o", str(so), str(source),
           str(CSRC / "routing_bwd.cu"), str(CSRC / "common.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed\n{res.stderr}")
    if ptxas:
        for line in res.stderr.splitlines():
            if "routing" in line or "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    lib = ctypes.CDLL(str(so))
    lib.tpuasr_error_string.argtypes = [ctypes.c_int]
    lib.tpuasr_error_string.restype = ctypes.c_char_p
    lib.tpuasr_routing_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tpuasr_routing_clocks.restype = ctypes.c_int
    return lib


def clocks(lib, rm, _build) -> None:
    """Cycles a capsule step by phase, from the TPUASR_ROUTING_CLOCKS build."""
    nph = len(PHASES) + 2      # slot 0 unused; the last the cluster steps
    with mock.patch.object(_build, "_lib", lib):
        for Bc in (8, 32):
            u, W, _ = inputs(rm, Bc)
            R = Bc * T
            plan = rm.routing_plan(R, I, DIN, O, D)
            nctas = plan.tiles * plan.cluster
            buf = torch.zeros((nctas, nph), dtype=torch.int64)

            def read():
                code = lib.tpuasr_routing_clocks(
                    ctypes.c_void_p(buf.data_ptr()), nctas)
                if code:
                    raise RuntimeError(f"clocks: {code}")

            rm.routed_caps(u, W, O, D, ITERS)
            torch.cuda.synchronize()
            read()
            n = 10
            ms = cuda_ms(lambda: rm.routed_caps(u, W, O, D, ITERS), n - 1)
            clk = sm_clock()
            read()
            # n calls (the warm-up and n - 1 timed); every CTA routes its
            # I / cluster capsules in each of 3 iterations, two of them
            # routed.
            steps = n * ITERS * (I // plan.cluster)
            per = buf[:, 1:-1].double().sum(0) / (nctas * steps)
            per[1:4] *= ITERS / (ITERS - 1)    # b, barrier, softmax: routed
            it = buf[:, -1].double().sum() / (nctas * n * ITERS)
            parts = "; ".join(f"{a} {v:.0f}" for a, v in zip(PHASES, per))
            print(f"K8 clocks B={Bc} ({R} rows, {plan.tiles} clusters of "
                  f"{plan.cluster} CTAs, {plan.rows} rows, {plan.stages} "
                  f"stages): "
                  f"{ms:.3f} ms; cycles a capsule step: {parts}; sum "
                  f"{per.sum():.0f}; cluster steps {it:.0f} an "
                  f"iteration (SM clock {clk})", flush=True)


def passes(lib, rm, _build) -> None:
    """K8 with and without saving, and K8b's three launches apart (from
    the TPUASR_ROUTING_CLOCKS build, whose tpuasr_routing_bwd_passes
    selects them; K8b has no counters)."""
    lib.tpuasr_routing_bwd_passes.argtypes = [ctypes.c_int]
    lib.tpuasr_routing_bwd_passes.restype = None
    for Bc in (8, 32):
        u, W, dv = inputs(rm, Bc)
        R = Bc * T
        print(f"K8 B={Bc}: {rm.max_active_clusters(R, I, DIN, O, D)} clusters "
              f"at once (cudaOccupancyMaxActiveClusters)", flush=True)
        fwd = cuda_ms(lambda: rm.routed_caps(u, W, O, D, ITERS))
        one = cuda_ms(lambda: rm.routed_caps(u, W, O, D, 1))
        save = cuda_ms(lambda: rm.routing_residuals(u, W, O, D, ITERS))
        _, V, s = rm.routing_residuals(u, W, O, D, ITERS)
        full = cuda_ms(lambda: rm.routed_caps_bwd_from(u, W, V, s, dv, O, D))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        nch = rm._row_chunks(R, I, sms)
        times = []
        with mock.patch.object(_build, "_lib", lib):
            for mask in (1, 2, 4):
                lib.tpuasr_routing_bwd_passes(mask)
                times.append(cuda_ms(
                    lambda: rm.routed_caps_bwd_from(u, W, V, s, dv, O, D)))
            lib.tpuasr_routing_bwd_passes(7)
        print(f"K8 B={Bc}: {fwd:.3f} ms ({one:.3f} at 1 iteration), saving "
              f"mode {save:.3f} ms (+"
              f"{save - fwd:.3f}); K8b from V and s {full:.3f} ms: ds "
              f"{times[0]:.3f}, pass 2 {times[1]:.3f}, chunk sum "
              f"({nch} chunks) {times[2]:.3f}", flush=True)
        del u, W, dv, V, s
        torch.cuda.empty_cache()


def clusters(rm) -> None:
    """K8 at each cluster size, the plan otherwise routing_plan's."""
    for Bc in (8, 32):
        u, W, _ = inputs(rm, Bc)
        R = Bc * T
        ref = rm.routed_caps_plain(u, W, O, D, ITERS)
        for C in (2, 1, 4, 8):
            with mock.patch.object(rm, "_CLUSTER", C):
                ok = torch.allclose(rm.routed_caps(u, W, O, D, ITERS), ref,
                                    rtol=2e-5, atol=2e-6)
                ms = cuda_ms(lambda: rm.routed_caps(u, W, O, D, ITERS))
                at_once = rm.max_active_clusters(R, I, DIN, O, D)
                plan = rm.routing_plan(R, I, DIN, O, D)
            print(f"K8 B={Bc} clusters of {C}: {ms:.3f} ms ({plan.tiles} "
                  f"tiles, {at_once} clusters at once, {plan.stages} stages;"
                  f" agrees with plain: {ok})", flush=True)
        del u, W, ref
        torch.cuda.empty_cache()


PR13_CLOCKS = r"""
#ifdef TPUASR_ROUTING_CLOCKS
__device__ unsigned long long g_clk[4096][4];
#define CLK_START long long _t0 = clock64();
#define CLK(p) { long long _t = clock64(); if (threadIdx.x == 0) \
  g_clk[blockIdx.x % 4096][p] += _t - _t0; _t0 = _t; }
#else
#define CLK_START
#define CLK(p)
#endif
"""
PR13_EXPORT = r"""
#ifdef TPUASR_ROUTING_CLOCKS
extern "C" int tpuasr_routing_clocks(unsigned long long* out, int n) {
  static unsigned long long host[4096][4];
  cudaError_t e = cudaMemcpyFromSymbol(host, g_clk, sizeof(host));
  if (e != cudaSuccess) return (int)e;
  for (int b = 0; b < n && b < 4096; ++b)
    for (int p = 0; p < 4; ++p) out[b * 4 + p] = host[b][p];
  static unsigned long long zero[4096][4];
  return (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(zero));
}
#endif
"""


def pr13_parts(parent: Path) -> None:
    """PR 13's K8 by phase and K8b's passes apart (see the module doc)."""
    def patch(text, pairs):
        for a, b in pairs:
            if text.count(a) != 1:
                raise RuntimeError(f"not PR 13's source: {a[:40]!r}")
            text = text.replace(a, b)
        return text

    fwd = patch((parent / "tpuasr_torch/csrc/routing.cu").read_text(), [
        ("namespace {\n", PR13_CLOCKS + "namespace {\n"),
        ("      const int i0 = chunk * kIC;\n",
         "      const int i0 = chunk * kIC;\n      CLK_START\n"),
        ("      // b[i, o] = sum_d u_hat",
         "      CLK(0)\n      // b[i, o] = sum_d u_hat"),
        ("      __syncthreads();\n\n      // Softmax over o,",
         "      CLK(1)\n      __syncthreads();\n\n      // Softmax over o,"),
        ("      if (STAGE) cp_async_wait_all();   // the next chunk's W has "
         "landed\n      __syncthreads();\n",
         "      if (STAGE) cp_async_wait_all();\n      __syncthreads();\n"
         "      CLK(2)\n"),
        ("            s[tr][tc] = fmaf(c, uh[ii][tr][tc], s[tr][tc]);\n"
         "        }\n    }\n",
         "            s[tr][tc] = fmaf(c, uh[ii][tr][tc], s[tr][tc]);\n"
         "        }\n      CLK(3)\n    }\n")]) + PR13_EXPORT
    bwd = patch((parent / "tpuasr_torch/csrc/routing_bwd.cu").read_text(), [
        ("namespace {\n", "static int g_mask = 7;\nextern \"C\" void "
         "tpuasr_routing_bwd_mask(int m) { g_mask = m; }\nnamespace {\n"),
        ("  int e = tpuasr_routing_bwd_prep(",
         "  int e = !(g_mask & 1) ? 0 : tpuasr_routing_bwd_prep("),
        ("  cudaError_t err;\n  if (Din <= 8)",
         "  cudaError_t err = cudaSuccess;\n  if (!(g_mask & 2)) {} "
         "else if (Din <= 8)"),
        ("  if (err != cudaSuccess || chunks == 1) return",
         "  if (err != cudaSuccess || chunks == 1 || !(g_mask & 4)) return")])
    sys.path.insert(0, str(parent))
    from tpuasr_torch import _build
    from tpuasr_torch.ops import routing as rm
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags in (("clocks", ["-DTPUASR_ROUTING_CLOCKS"]),
                            ("plain", [])):
            d = Path(tmp) / name
            d.mkdir()
            (d / "routing.cu").write_text(fwd)
            (d / "routing_bwd.cu").write_text(bwd)
            so = d / "lib.so"
            res = subprocess.run(
                [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                 str(so), str(d / "routing.cu"), str(d / "routing_bwd.cu"),
                 str(parent / "tpuasr_torch/csrc/common.cu")],
                capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(f"nvcc failed\n{res.stderr}")
            lib = ctypes.CDLL(str(so))
            lib.tpuasr_error_string.argtypes = [ctypes.c_int]
            lib.tpuasr_error_string.restype = ctypes.c_char_p
            libs[name] = lib
        for Bc in (8, 32):
            u, W, dv = inputs(rm, Bc)
            nblk = -(-Bc * T // 8)
            buf = (ctypes.c_ulonglong * (4096 * 4))()
            with mock.patch.object(_build, "_lib", libs["clocks"]):
                rm.routed_caps(u, W, O, D, ITERS)
                torch.cuda.synchronize()
                libs["clocks"].tpuasr_routing_clocks(buf, 4096)
                n = 10
                ms = cuda_ms(lambda: rm.routed_caps(u, W, O, D, ITERS), n - 2)
                libs["clocks"].tpuasr_routing_clocks(buf, 4096)
            per = [sum(buf[b * 4 + q] for b in range(nblk)) /
                   (nblk * n * ITERS * (I // 2)) for q in range(4)]
            names = ("u_hat", "b", "barriers + softmax", "s")
            print(f"PR 13 K8 clocks B={Bc}: {ms:.3f} ms; cycles a chunk of 2 "
                  "capsules (thread 0): " + "; ".join(
                      f"{a} {v:.0f}" for a, v in zip(names, per)) +
                  f"; sum {sum(per):.0f} (SM clock {sm_clock()})", flush=True)
            lib = libs["plain"]
            with mock.patch.object(_build, "_lib", lib):
                k8 = cuda_ms(lambda: rm.routed_caps(u, W, O, D, ITERS))
                parts = []
                for mask in (7, 1, 2, 4):
                    lib.tpuasr_routing_bwd_mask(mask)
                    parts.append(cuda_ms(lambda: rm.routed_caps_bwd(
                        u, W, dv, O, D, ITERS)))
                lib.tpuasr_routing_bwd_mask(7)
            print(f"PR 13 B={Bc}: K8 {k8:.3f} ms; K8b {parts[0]:.3f}: pass 1 "
                  f"{parts[1]:.3f}, pass 2 {parts[2]:.3f}, chunk sum "
                  f"{parts[3]:.3f}", flush=True)
            del u, W, dv
            torch.cuda.empty_cache()


def time_root(root: Path) -> None:
    """One side of --parent: K8 and K8b of the package under root."""
    sys.path.insert(0, str(root))
    from tpuasr_torch.ops import routing as rm
    out = {"root": str(root)}
    for Bc in (8, 32):
        u, W, dv = inputs(rm, Bc)
        out[f"K8 B={Bc}"] = cuda_ms(lambda: rm.routed_caps(u, W, O, D, ITERS))
        out[f"K8b standalone B={Bc}"] = cuda_ms(
            lambda: rm.routed_caps_bwd(u, W, dv, O, D, ITERS))
        if hasattr(rm, "routed_caps_bwd_from"):
            _, V, s = rm.routing_residuals(u, W, O, D, ITERS)
            out[f"K8b train B={Bc}"] = cuda_ms(
                lambda: rm.routed_caps_bwd_from(u, W, V, s, dv, O, D))
        else:    # PR 13's backward reran the routing (its pass 1)
            out[f"K8b train B={Bc}"] = out[f"K8b standalone B={Bc}"]
        del u, W, dv
        torch.cuda.empty_cache()
    out.update(train_steps())
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in out.items()}), flush=True)


def train_steps() -> dict:
    """ms of config 4's train step at B=8 and 32 (see the module doc)."""
    import numpy as np
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(model="capsule1", num_classes=O, warmup_steps=1)
    trainer = Trainer(cfg, FeatureConfig(), device="cuda")
    S, U, out = 40000, 16, {}
    for Bc in (8, 32):
        rng = np.random.default_rng(0)
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in dict(
            wav=(rng.standard_normal((Bc, S)) * 0.2).astype(np.float32),
            wav_lens=np.full((Bc,), S, np.int32),
            tokens=rng.integers(1, O, (Bc, U)).astype(np.int32),
            token_lens=np.full((Bc,), U, np.int32),
            real=np.ones((Bc,), np.float32)).items()}
        state = trainer.init_state()
        with torch.no_grad():
            state.model.W_route.mul_(20.0)

        def step():
            nonlocal state
            state, _ = trainer.train_step(state, batch)

        out[f"train step B={Bc}"] = cuda_ms(step, 10)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=str(CSRC / "routing.cu"))
    ap.add_argument("--parent", default=None)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--clusters", action="store_true")
    ap.add_argument("--pr13", default=None)
    ap.add_argument("--time-root", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    if args.time_root:
        time_root(Path(args.time_root).resolve())
        return 0
    print(card(), flush=True)
    if args.pr13:
        pr13_parts(Path(args.pr13).resolve())
        return 0
    sys.path.insert(0, str(ROOT))
    from tpuasr_torch import _build
    from tpuasr_torch.ops import routing as rm
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(args.source), Path(tmp), args.ptxas)
        clocks(lib, rm, _build)
        passes(lib, rm, _build)
    if args.clusters:
        clusters(rm)
    if args.parent:
        parent = Path(args.parent).resolve()
        for root in (parent, ROOT, ROOT, parent):
            res = subprocess.run([sys.executable, __file__, "--time-root",
                                  str(root)], capture_output=True, text=True)
            if res.returncode:
                print(res.stderr[-3000:], file=sys.stderr)
                return 1
            print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
