"""tools/k4_variants.py's variants of K4 (the tool builds and times them on
the card): each substitution still finds its text in csrc/proj_sample.cu,
so a change to K4's source that leaves a variant stale fails here."""

import os

from kimera_semantics_tpu_torch.ops import _build
from kimera_semantics_tpu_torch.tools import k4_variants


def test_every_variant_applies_to_the_source():
    with open(os.path.join(_build.CSRC, "proj_sample.cu")) as f:
        src = f.read()
    v = k4_variants.variants(src)
    assert v[k4_variants.CHOSEN] == src
    others = [s for n, s in v.items() if n != k4_variants.CHOSEN]
    assert len(others) == 17
    assert all(s != src for s in others)
    assert len(set(others)) == len(others)
