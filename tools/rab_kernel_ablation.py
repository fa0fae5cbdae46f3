#!/usr/bin/env python3
"""Where the time of the attention kernels goes, by ablation: K1
(hstu_rab_fwd), K2 (hstu_rab_bwd), K2a (hstu_rab_bwd_dq), K2b
(hstu_rab_bwd_dkv) and K3 (hstu_attn_fwd, the materialised-bias forward).

    python3 tools/rab_kernel_ablation.py

Needs a CUDA device and nvcc.  Builds copies of ``csrc/hstu_rab_fwd.cu``,
``csrc/hstu_rab_bwd.cu`` and ``csrc/hstu_attn_fwd.cu`` with one part of the
work taken out (the tensor-core passes, the bucket lookup, the
table-gradient sums, the second ring stage, the staging of K3's bias, ...),
times each at the serving shape (B8 H8 L256, dqk = dv = 32; K3 on the
serving model's own per-batch rab, ``chip_smoke.py``'s case (a)) and at
L1024 the way ``chip_smoke.py`` times the kernels, and prints the
difference to the unchanged kernel.  A variant whose text is not in the source fails the run,
so no variant times an unchanged copy; copies with the same text are built
once.  A variant computes wrong values by design: only the unchanged build
is checked against the plain version.  Also prints the atomic, tensor-core
and cp.async (LDGSTS) instructions of each unchanged kernel at dqk = dv = 32
(cuobjdump), and the card's name and power limit.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from torch_rechub_tpu_torch.ops.cuda import _build  # noqa: E402
from torch_rechub_tpu_torch.ops.cuda import hstu_rab_attention as rab  # noqa: E402

OUT = ROOT / "build" / "ablation"
MMA3 = "  mma_tf32(d, al, bh);\n  mma_tf32(d, ah, bl);\n  mma_tf32(d, ah, bh);"
HEADER = {  # variants of hstu_rab_common.cuh
    "one TF32 pass (hi*hi only)": [(MMA3, "  mma_tf32(d, ah, bh);")],
    "no products (operands still loaded and split)": [(MMA3, "  d[0] += __uint_as_float(ah[0] ^ bh[0] ^ al[0] ^ bl[0]);")],
}
LIBRARY = {"hstu_rab_fwd": "hstu_rab_fwd", "hstu_rab_bwd": "hstu_rab_bwd", "hstu_rab_bwd_dq": "hstu_rab_bwd", "hstu_rab_bwd_dkv": "hstu_rab_bwd", "hstu_attn_fwd": "hstu_attn_fwd"}
FUNCTION = {"hstu_rab_fwd": "hstu_rab_fwd_kernel", "hstu_rab_bwd": "bwd_fused_kernel", "hstu_rab_bwd_dq": "bwd_q_kernel", "hstu_rab_bwd_dkv": "bwd_kv_kernel", "hstu_attn_fwd": "hstu_attn_fwd_kernel"}
ONE_STAGE = [("    f.stages = option < 2 ? 2 : 1;", "    f.stages = 1;")]  # K2, K2a and K2b choose their ring alike
VARIANTS = {  # kernel: {name: (header substitutions, source substitutions)}
    "hstu_rab_fwd": {
        "unchanged": ([], []),
        **{k: (v, []) for k, v in HEADER.items()},
        "a constant bucket (no lookup)": ([], [("if (has_time) x += tw[bucket(tq_r[i >> 1], tk[c])];", "if (has_time) x += tw[3];")]),
        "no score path (P = 0)": ([], [("          if (l < L && m <= l && (p.mask == nullptr || km[c])) {", "          if (false) {")]),
    },
    "hstu_rab_bwd": {
        "unchanged": ([], []),
        **{k: (v, []) for k, v in HEADER.items()},
        "a constant bucket (no lookup)": ([], [("              const int u = bucket(tq[qq], tk_r[i >> 1]);", "              const int u = 3;")]),
        "no dts sums": ([], [("        add_ts_grads<8>(my_gts, dsk, bkk);", "")]),
        "no dpos sums": ([], [("        add_pos_grads<1>(gpos, part, l0 - m0, n_dist, g, t);", "")]),
        "no dq atomics": ([], [("              red_add_v4(dst, x0, x1, x2, x3);", "")]),
        "one CTA-wide dts table (no copies)": ([], [("    f.ts_copies = option % 2 == 0 ? kTsCopies : 1;", "    f.ts_copies = 1;")]),
        "one Q/G stage (no ring)": ([], ONE_STAGE),
    },
    "hstu_rab_bwd_dq": {
        "unchanged": ([], []),
        **{k: (v, []) for k, v in HEADER.items()},
        "a constant bucket (no lookup)": ([], [("              const int u = bucket(tq_r[i >> 1], tk[c]);", "              const int u = 3;")]),
        "no dts sums": ([], [("        add_ts_grads<8>(my_gts, dsr, bkr);", "")]),
        "no dpos sums": ([], [("      add_pos_grads<-1>(gpos, part, r0 - m0, q_end, g, t);", "")]),
        "one CTA-wide dts table (no copies)": ([], [("    f.ts_copies = option % 2 == 0 ? kTsCopies : 1;", "    f.ts_copies = 1;")]),
        "one K/V stage (no ring)": ([], ONE_STAGE),
    },
    "hstu_rab_bwd_dkv": {  # no table gradients: nothing of dts or dpos to take out
        "unchanged": ([], []),
        **{k: (v, []) for k, v in HEADER.items()},
        "a constant bucket (no lookup)": ([], [("              const int u = bucket(tq[qq], tk_r[i >> 1]);", "              const int u = 3;")]),
        "one Q/G stage (no ring)": ([], ONE_STAGE),
    },
    "hstu_attn_fwd": {
        "unchanged": ([], []),
        **{k: (v, []) for k, v in HEADER.items()},
        "no score path (P = S: no mask, bias or silu)": ([], [("            if (l < L && m <= l && (p.mask == nullptr || km[c])) {", "            pv = s[nt][i];\n            if (false) {")]),
        "one K/V/bias stage (no ring)": ([], [("  p.stages = 2;", "  p.stages = 1;")]),
        "the bias read from global memory in the score loop (not staged)": ([], [
            ("    copy_causal_tile(st + lay.b, ldb, bb, q0, kBlockQ, k0, BK, L, p.vec_b, tid, kThreads);\n", ""),
            ("      const float* brow[2] = {st + lay.b + (16 * rg + g) * ldb + c0 + 2 * t, st + lay.b + (16 * rg + g + 8) * ldb + c0 + 2 * t};",
             "      const float* brow[2] = {bb + (size_t)(r0 + g) * L + m0 + 2 * t, bb + (size_t)(r0 + g + 8) * L + m0 + 2 * t};"),
        ]),
    },
}


def substitute(text, subs, what):
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{what}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def variant_sources():
    """{(kernel, variant): (header text, source text)}; raises where a substitution finds nothing."""
    header = (_build.CSRC / "hstu_rab_common.cuh").read_text()
    return {(kernel, name): (substitute(header, hsubs, f"{kernel} {name}"), substitute(_build.SOURCES[LIBRARY[kernel]].read_text(), subs, f"{kernel} {name}"))
            for kernel, variants in VARIANTS.items() for name, (hsubs, subs) in variants.items()}


def build_all():
    """Every variant's library, built in parallel, one build per distinct text: {(kernel, variant): path}."""
    nvcc = _build._nvcc()
    procs, libs = {}, {}
    for key, (header, source) in variant_sources().items():
        d = OUT / hashlib.sha256((header + source).encode()).hexdigest()[:16]
        libs[key] = d / "k.so"
        if d not in procs:
            d.mkdir(parents=True, exist_ok=True)
            (d / "hstu_rab_common.cuh").write_text(header)
            (d / "k.cu").write_text(source)
            cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(d / "k.so"), str(d / "k.cu")]
            procs[d] = (key, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for key, proc in procs.values():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key} did not build:\n{out}")
    return libs


def sass_counts(path, function):
    """Atomic, tensor-core and cp.async instructions of ``function``'s instantiation for dqk, dv <= 32 (N = 4)."""
    sass = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(path)], capture_output=True, text=True, check=True).stdout
    body = next((part for part in sass.split("Function : ")[1:] if re.match(rf"\S*{function}ILi4E", part)), "")
    return dict(collections.Counter(re.findall(r"\b(ATOMS\.[A-Z0-9.]+|REDG?\.[A-Z0-9.]+|HMMA\.[A-Z0-9.]+|LDGSTS(?:\.[A-Z0-9.]+)*)", body)))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("rab_kernel_ablation.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    paths = build_all()
    cycles_per_ms = cs.spin_cycles_per_ms()
    rab_cases = {"B8 L256": cs.rab_case(0, 8, 256, 256), "B8 L1024": cs.rab_case(4, 8, 1024, 1024)}
    bias_cases = {"B8 L256": cs.bias_case(20, 8, 256, 256), "B8 L1024": cs.bias_case(25, 8, 1024, 1024)}
    grads = {k: torch.from_numpy(np.random.default_rng(10).normal(size=tuple(c["v"].shape)).astype(np.float32)).cuda() for k, c in rab_cases.items()}

    def args(c, g):
        return (c["q"], c["k"], c["v"], g, c["pos_w"], c["ts_w"], c["ts"], c["mask"], c["alpha"], c["max_seq_len"], c["cfg"], c["thr"])

    calls = {  # kernel: (its cases, call, index of its first output in dense_backward's gradients)
        "hstu_rab_fwd": (rab_cases, lambda c, g: cs.run_kernel(c), None),
        "hstu_rab_bwd": (rab_cases, lambda c, g: rab.rab_backward_fused(*args(c, g)), 0),
        "hstu_rab_bwd_dq": (rab_cases, lambda c, g: rab.rab_backward_dq(*args(c, g)), 0),
        "hstu_rab_bwd_dkv": (rab_cases, lambda c, g: rab.rab_backward_dkv(*args(c, g)), 1),
        "hstu_attn_fwd": (bias_cases, lambda c, g: cs.run_op(c), None),
    }
    plain = {"hstu_rab_fwd": cs.run_plain, "hstu_attn_fwd": cs.run_op_plain}  # the forwards' plain versions
    loaded = {}
    real_load = _build.load
    _build.load = lambda name: loaded[name]
    try:
        for kernel, variants in VARIANTS.items():
            print(f"{kernel} (device ms, medians of {cs.REPS}; difference to the unchanged kernel):")
            base = {}
            cases, call, first = calls[kernel]
            for name in variants:
                loaded[LIBRARY[kernel]] = ctypes.CDLL(str(paths[kernel, name]))
                if name == "unchanged":
                    c, g = cases["B8 L256"], grads["B8 L256"]
                    out = call(c, g)
                    out = out if first is None else out[0]
                    ref = plain[kernel](c) if first is None else rab.dense_backward(*args(c, g)[:-1], True)[first]
                    cs.check_close(f"{kernel} (unchanged build)", out, ref, cs.KERNEL_RTOL, cs.KERNEL_ATOL)
                    print(f"  SASS of {FUNCTION[kernel]}<4>, the unchanged build: {sass_counts(paths[kernel, name], FUNCTION[kernel])}")
                parts = []
                for case, c in cases.items():
                    ms, _ = cs.timed(lambda c=c, g=grads[case]: call(c, g), cycles_per_ms)
                    if name == "unchanged":
                        base[case] = ms
                        parts.append(f"{case} {ms:.4f}")
                    else:
                        parts.append(f"{case} {ms:.4f} ({ms - base[case]:+.4f})")
                print(f"  {name}: " + ", ".join(parts))
    finally:
        _build.load = real_load


if __name__ == "__main__":
    main()
