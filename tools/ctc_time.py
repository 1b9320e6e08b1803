"""Time the CTC loss kernels (K6, K6b) and the whole loss on one card.

    python3 tools/ctc_time.py [--reps N] [--clocks]
                              [--source FILE] [--root DIR] [--out FILE]

At config 3's train shape (B=16 utterances of T'=249 frames, C=64 classes,
U=24 labels: S=49), at B=64, at config 4's (B=8, C=48, U=16: S=33) and at
S=1023 (B=4, T'=1100, U=511), on seeded log-probs with ragged lengths as
chip_smoke's: K6 (ctc_forward) and K6b (ctc_backward) ms, the whole loss
(ctc_loss) forward and forward+backward, and F.ctc_loss's, each the mean of
--reps calls queued behind a sleep of the stream (CUDA events; the host
launch path is not timed). --clocks builds csrc/ctc_fb.cu with
TPUASR_CTC_CLOCKS and prints the mean SM clock cycles a frame by part as
lane 0 of each utterance's warp sees them (each part waits for its last
result, so the parts do not overlap), the SM clock nvidia-smi reads, and
the serial floor: T'-1 frames times the bare chain's cycles a frame (one
warp running only the alpha steps, tpuasr_ctc_chain_cycles, at 1, 2 and 32
states a lane) at that clock. --source builds FILE (another version of
csrc/ctc_fb.cu with the same C interface, for example one rebuilt from the
history) and times it in turns with the package's build (package, source,
source, package), each call's results compared with the package's.
--root imports tpuasr_torch from another checkout (for example the parent
commit, unpacked by git archive) and times its ctc_loss, forward and
forward+backward, in turns with this tree's in the same process (root,
this, this, root), then config 3's and config 4's train steps of both
trees in fresh processes, in the same turns: wall ms (CUDA events, mean of
10 steps) and device ms of one step (torch.profiler, the kernels' self
times). Prints the card's name and power limit first; --out
writes the numbers as JSON. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402
from tpuasr_torch import _build  # noqa: E402
from tpuasr_torch.losses import ctc as ctc_mod  # noqa: E402

FWD_PARTS = ("setup", "chain", "rest", "ll")
# K6b's parts: the sum warp waiting for a full buffer and working on it,
# the chain warp's setup and frames (each part a frame's share).
BWD_PARTS = ("-", "sum warp waiting", "sum warp working", "chain warp setup",
             "chain warp frames")
# (label, B, T', C, U) of the timed shapes.
SHAPES = (("config 3", 16, 249, 64, 24), ("config 3", 64, 249, 64, 24),
          ("config 4", 8, 249, 48, 16), ("S=1023", 4, 1100, 64, 511))


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def build(source: Path, out: Path, *defines: str) -> ctypes.CDLL:
    """FILE (with common.cu) as a library with the package's flags."""
    so = out / f"ctc_{len(list(out.iterdir()))}.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *defines, "-o", str(so),
           str(source), str(_build.CSRC_DIR / "common.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.tpuasr_error_string.argtypes = [ctypes.c_int]
    lib.tpuasr_error_string.restype = ctypes.c_char_p
    return lib


def batch(B, T, C, U, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return cs.ctc_batch(gen, B, T, C, U, False)


def kernel_ms(args, reps):
    """(K6 ms, K6b ms, outputs) on args."""
    g = torch.ones(args[0].shape[0], device="cuda")
    loss, ll, alphas = ctc_mod.ctc_forward(*args)
    grad = ctc_mod.ctc_backward(*args, alphas, ll, g)
    fwd = cs.queued_ms(lambda: ctc_mod.ctc_forward(*args), reps)
    bwd = cs.queued_ms(lambda: ctc_mod.ctc_backward(*args, alphas, ll, g),
                       reps)
    return fwd, bwd, (loss, alphas, grad)


def loss_ms(mod, args, reps):
    """(forward ms, forward+backward ms) of mod.ctc_loss on args."""
    lp, labels, il, ll = args
    x = lp.clone().requires_grad_()
    g = torch.ones(lp.shape[0], device="cuda")
    with torch.no_grad():
        f = cs.queued_ms(lambda: mod.ctc_loss(lp, labels, il, ll), reps)
    fb = cs.queued_ms(lambda: torch.autograd.grad(
        mod.ctc_loss(x, labels, il, ll), x, g), reps)
    return f, fb


def library_ms(args, reps):
    lp, labels, il, ll = args
    C = lp.shape[2]
    lp_t = lp.permute(1, 0, 2).detach().clone().requires_grad_()
    lab, il1 = labels.clamp(0, C - 1).long(), il.clamp(1, lp.shape[1])
    g = torch.ones(lp.shape[0], device="cuda")

    def call():
        return torch.nn.functional.ctc_loss(lp_t, lab, il1, ll,
                                            reduction="none",
                                            zero_infinity=True)

    with torch.no_grad():
        f = cs.queued_ms(call, reps)
    fb = cs.queued_ms(lambda: torch.autograd.grad(call(), lp_t, g), reps)
    return f, fb


def clocks(tmp: Path, reps: int, res: dict) -> None:
    lib = build(_build.CSRC_DIR / "ctc_fb.cu", tmp, "-DTPUASR_CTC_CLOCKS")
    lib.tpuasr_ctc_clocks.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_int]
    lib.tpuasr_ctc_chain_cycles.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p, ctypes.c_void_p]
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(32, device="cuda")
    chain = {}
    for K in (1, 2, 32):
        for frames in (64, 1024):        # the difference: no fixed costs
            code = lib.tpuasr_ctc_chain_cycles(K, frames,
                                               ctypes.c_void_p(cyc.data_ptr()),
                                               ctypes.c_void_p(sink.data_ptr()))
            if code:
                raise RuntimeError(f"chain: {code}")
            torch.cuda.synchronize()
            chain[K, frames] = int(cyc.item())
        chain[K] = (chain[K, 1024] - chain[K, 64]) / 960
        print(f"bare chain, K={K} states a lane: {chain[K]:.1f} SM cycles a "
              f"frame", flush=True)
    res["chain_cycles"] = {str(K): chain[K] for K in (1, 2, 32)}
    with mock.patch.object(_build, "_lib", lib):
        for label, B, T, C, U in SHAPES:
            args = batch(B, T, C, U)
            fwd, bwd, _ = kernel_ms(args, reps)
            clk = smi("clocks.sm")
            mhz = float(clk.split()[0])
            il = args[2].clamp(1, T).tolist()
            row = {"fwd_ms": fwd, "bwd_ms": bwd, "sm_clock": clk}
            for k, (kname, parts, frames) in enumerate((
                    ("K6", FWD_PARTS, B * (T - 1)),
                    ("K6b", BWD_PARTS, sum(il)))):
                host = torch.zeros((B, 5), dtype=torch.int64)
                code = lib.tpuasr_ctc_clocks(
                    k, ctypes.c_void_p(host.data_ptr()), B)
                if code:
                    raise RuntimeError(f"clocks: {code}")
                per = (host.double().sum(0) / frames).tolist()
                row[kname] = dict(zip(parts, per))
                text = ", ".join(f"{n} {v:.1f}" for n, v in
                                 zip(parts, per) if n != "-")
                floor = chain[ctc_mod.lane_states(2 * U + 1)] * (T - 1) / (
                    mhz * 1e3)
                row[kname + "_floor_ms"] = floor
                print(f"{kname} clocks {label} B={B} T={T} C={C} "
                      f"S={2 * U + 1}: SM cycles a frame: {text} (SM clock "
                      f"{clk}); serial floor {floor:.4f} ms; ms with the "
                      f"counters {fwd if k == 0 else bwd:.4f}", flush=True)
            res[f"clocks {label} B={B}"] = row


def in_turns(source: Path, tmp: Path, reps: int, res: dict) -> None:
    """The package's build and FILE's, in turns."""
    pkg = _build.lib()
    other = build(source, tmp)
    name = source.name
    for turn in ("package", "source", "source", "package"):
        lib = other if turn == "source" else pkg
        with mock.patch.object(_build, "_lib", lib):
            for label, B, T, C, U in SHAPES[:3]:
                args = batch(B, T, C, U)
                with mock.patch.object(_build, "_lib", pkg):
                    _, _, want = kernel_ms(args, 1)
                fwd, bwd, got = kernel_ms(args, reps)
                err = max((a - b).abs().max().item()
                          for a, b in zip(got, want))
                print(f"in turns, {turn} ({name if turn == 'source' else 'csrc/ctc_fb.cu'}) "
                      f"{label} B={B}: K6 {fwd:.4f} ms, K6b {bwd:.4f} ms "
                      f"(max difference from the package's {err:.3e})",
                      flush=True)
                res.setdefault(f"turns {name} {label} B={B}", []).append(
                    (turn, fwd, bwd, err))


def root_turns(root: Path, reps: int, res: dict) -> None:
    """The whole loss of another checkout and of this tree, in turns."""
    saved = {n: m for n, m in sys.modules.items()
             if n.startswith("tpuasr_torch")}
    for n in saved:
        del sys.modules[n]
    sys.path.insert(0, str(root.resolve()))
    try:
        other = importlib.import_module("tpuasr_torch.losses.ctc")
        importlib.import_module("tpuasr_torch._build").lib()
    finally:
        sys.path.remove(str(root.resolve()))
        for n in [n for n in sys.modules if n.startswith("tpuasr_torch")]:
            del sys.modules[n]
        sys.modules.update(saved)
    for turn in ("root", "this", "this", "root"):
        mod = other if turn == "root" else ctc_mod
        for label, B, T, C, U in SHAPES[:3]:
            f, fb = loss_ms(mod, batch(B, T, C, U), reps)
            print(f"ctc_loss in turns, {turn} ({root if turn == 'root' else HERE}) "
                  f"{label} B={B}: forward {f:.4f} ms, forward+backward "
                  f"{fb:.4f} ms", flush=True)
            res.setdefault(f"loss turns {label} B={B}", []).append(
                (turn, f, fb))


def device_ms(fn) -> float:
    """The device time of one call: the kernels' self times summed
    (torch.profiler), as chip_smoke.device_breakdown sums them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in cs.device_rows(prof)) / 1e3


def train_steps() -> dict:
    """Config 3's train step (the 512 x 4 DeepSpeechCTC with K5/K5b, B=16
    x 5 s, U=24) and config 4's (capsule1, 48 classes, W_route scaled by 20,
    B=8 x 5 s, U=16), as chip_smoke's phases 7 and 8 run them: wall ms (CUDA
    events, mean of 10 steps after two) and the device ms of one step."""
    import numpy as np
    from tpuasr_torch.features import FeatureConfig
    from tpuasr_torch.train import TrainConfig, Trainer

    out = {}
    for name, cfg, B, U in (
            ("config 3 B=16", TrainConfig(
                model="deepspeech_ctc", num_classes=cs.NUM_CLASSES,
                warmup_steps=1, model_kwargs=dict(
                    rnn_hidden=cs.HIDDEN, rnn_layers=cs.LAYERS,
                    pallas_gru=True)), cs.TRAIN_B, cs.TRAIN_U),
            ("config 4 B=8", TrainConfig(
                model="capsule1", num_classes=cs.CAPS_CLASSES,
                warmup_steps=1), 8, cs.CAPS_TRAIN_U)):
        S = int(cs.SR * cs.TRAIN_SECONDS)
        rng = np.random.default_rng(cs.SEED)
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in dict(
            wav=(rng.standard_normal((B, S)) * 0.2).astype(np.float32),
            wav_lens=np.full((B,), S, np.int32),
            tokens=rng.integers(1, cfg.num_classes, (B, U)).astype(np.int32),
            token_lens=np.full((B,), U, np.int32),
            real=np.ones((B,), np.float32)).items()}
        trainer = Trainer(cfg, FeatureConfig(), device="cuda")
        state = trainer.init_state()
        if cfg.model == "capsule1":
            with torch.no_grad():
                state.model.W_route.mul_(cs.CAPS_W_SCALE)

        def step():
            nonlocal state
            state, _ = trainer.train_step(state, batch)

        out[name] = {"wall_ms": cs.cuda_ms(step, 10, warmup=2),
                     "device_ms": device_ms(step)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--source", default="")
    ap.add_argument("--root", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--train-root", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    if args.train_root:         # one side of --root's train steps
        for n in [n for n in sys.modules if n.startswith("tpuasr_torch")]:
            del sys.modules[n]
        sys.path.insert(0, str(Path(args.train_root).resolve()))
        print(json.dumps(train_steps()), flush=True)
        return 0
    card = smi("name,power.limit")
    print(card, flush=True)
    res = {"card": card}
    _build.lib()
    for label, B, T, C, U in SHAPES:
        a = batch(B, T, C, U)
        fwd, bwd, _ = kernel_ms(a, args.reps)
        f, fb = loss_ms(ctc_mod, a, args.reps)
        lf, lfb = library_ms(a, args.reps)
        print(f"{label} B={B} T={T} C={C} S={2 * U + 1}: K6 {fwd:.4f} ms, "
              f"K6b {bwd:.4f} ms; ctc_loss forward {f:.4f} ms, "
              f"forward+backward {fb:.4f} ms; F.ctc_loss {lf:.4f}, "
              f"{lfb:.4f} ms", flush=True)
        res[f"{label} B={B}"] = dict(K6=fwd, K6b=bwd, loss_fwd=f,
                                     loss_fwdbwd=fb, lib_fwd=lf,
                                     lib_fwdbwd=lfb)
    with tempfile.TemporaryDirectory() as tmp:
        if args.clocks:
            clocks(Path(tmp), args.reps, res)
        if args.source:
            in_turns(Path(args.source), Path(tmp), args.reps, res)
    if args.root:
        root_turns(Path(args.root), args.reps, res)
        for turn in ("root", "this", "this", "root"):
            tree = Path(args.root) if turn == "root" else HERE
            out = subprocess.run([sys.executable, __file__, "--train-root",
                                  str(tree)], capture_output=True, text=True)
            if out.returncode:
                print(out.stderr[-3000:], file=sys.stderr)
                return 1
            steps = json.loads(out.stdout.strip().splitlines()[-1])
            print(f"train steps in turns, {turn} ({tree}): " + "; ".join(
                f"{k}: wall {v['wall_ms']:.3f} ms, device {v['device_ms']:.3f}"
                f" ms" for k, v in steps.items()), flush=True)
            res.setdefault("train turns", []).append((turn, steps))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
