"""The ablation tool's variants (``tools/rab_kernel_ablation.py``) on the CPU.

Each variant rewrites a piece of text in the kernel sources; a refactor of
the sources that moves that text must not leave the tool timing an
unchanged copy under a variant's name.  Building and timing need the card.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import rab_kernel_ablation as ablation  # noqa: E402

VARIANTS = [(kernel, name) for kernel, variants in ablation.VARIANTS.items() for name in variants if name != "unchanged"]


@pytest.fixture(scope="module")
def sources():
    return ablation.variant_sources()


@pytest.mark.parametrize("kernel,name", VARIANTS, ids=lambda x: str(x))
def test_variant_changes_the_source(sources, kernel, name):
    assert sources[kernel, name] != sources[kernel, "unchanged"]


def test_every_rab_kernel_has_its_variants():
    assert set(ablation.VARIANTS) == {"hstu_rab_fwd", "hstu_rab_bwd", "hstu_rab_bwd_dq", "hstu_rab_bwd_dkv"}
    for kernel in ("hstu_rab_bwd_dq", "hstu_rab_bwd_dkv"):
        assert {"one TF32 pass (hi*hi only)", "a constant bucket (no lookup)"} <= set(ablation.VARIANTS[kernel])
    assert {"no dts sums", "no dpos sums"} <= set(ablation.VARIANTS["hstu_rab_bwd_dq"])


def test_a_missing_text_fails_the_variant():
    with pytest.raises(RuntimeError, match="no longer holds"):
        ablation.substitute("int x = 1;", [("int y = 2;", "")], "a variant")
