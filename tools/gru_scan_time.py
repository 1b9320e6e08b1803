"""Time K2/K4 (csrc/gru_scan.cu) on one card at the shapes the main paths use.

    python3 tools/gru_scan_time.py

Builds the kernels, then for the served layer (T=499, B=128, D=1024,
H=512, bf16 streams) times K2 in bf16, K4 in int8 and K4 with rec_q8, and
for the deepspeech_var train step's forward (T=249, H=384, D=768, B=16
and 64) K2 in float32: each call with CUDA events, its two launches (the
projection and the recurrence) apart, and torch.nn.GRU (cuDNN) on the same
layer in the same type, TF32 off. Each case is also held against its plain
version (bf16 and int8: 2e-2; f32: 1e-4 of the largest magnitude). Prints
the card's name and power limit first. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (its timing helpers)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from tpuasr_torch import _build
    from tpuasr_torch.ops import gru as gru_mod
    from tpuasr_torch.ops.quant import quantize_per_channel
    from tpuasr_torch.precision import full_fp32

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.lib()
    gen = torch.Generator().manual_seed(0)
    ok = True
    T, B, D, H = 499, 128, 1024, 512
    x = torch.randn(T, B, D, generator=gen).cuda().bfloat16()
    wx = (torch.randn(D, 3 * H, generator=gen) / D ** 0.5).cuda()
    wh = (torch.randn(H, 3 * H, generator=gen) / H ** 0.5).cuda()
    bias = (torch.randn(3 * H, generator=gen) * 0.1).cuda()
    lens = torch.randint(T // 2, T + 1, (B,), generator=gen)
    mask = (torch.arange(T)[:, None] < lens[None, :]).float()[:, :, None]
    mask = mask.cuda().contiguous()
    lib = cs.library_gru_ms(T, B, D, H, torch.bfloat16, False)
    for key, label, kern, plain, args, kw in cs.xfused_cases(
            gru_mod, quantize_per_channel, x, wx, wh, bias, mask):
        err = (kern(*args, **kw).float()
               - plain(*args, **kw).float()).abs().max().item()
        ms = cs.cuda_ms(lambda: kern(*args, **kw), 5)
        ok &= err <= 2e-2
        print(f"{key} {label} T={T} B={B} D={D} H={H}: {ms:.3f} ms "
              f"(torch.nn.GRU bf16 {lib:.3f} ms), max_abs_err {err:.3e}; "
              f"{cs.xfused_split(gru_mod, key, args, kw)}", flush=True)
    T, D, H = 249, 768, 384
    for Bt in (16, 64):
        x = torch.randn(T, Bt, D, generator=gen).cuda()
        wx = (torch.randn(D, 3 * H, generator=gen) / D ** 0.5).cuda()
        wh = (torch.randn(H, 3 * H, generator=gen) / H ** 0.5).cuda()
        b = (torch.randn(3 * H, generator=gen) * 0.1).cuda()
        mask = torch.ones(T, Bt, 1, device="cuda")
        args = (x, wx, b, wh, mask)
        with full_fp32():
            got = gru_mod.gru_scan_xfused(*args)
            ref = gru_mod.gru_scan_xfused_plain(*args)
            err = ((got - ref).abs().max() / ref.abs().max()).item()
            ms = cs.cuda_ms(lambda: gru_mod.gru_scan_xfused(*args), 10)
            lib = cs.library_gru_ms(T, Bt, D, H, torch.float32, False)
            split = cs.xfused_split(gru_mod, "K2", args, {})
        ok &= err <= 1e-4
        print(f"K2 f32 T={T} B={Bt} D={D} H={H}: {ms:.3f} ms (torch.nn.GRU "
              f"f32 {lib:.3f} ms), error {err:.3e} of the largest magnitude;"
              f" {split}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
