"""``_build._spill_sites``: the spill instructions of a kernel's SASS and
those inside a loop, on hand-written ``cuobjdump -sass`` listings (the
card's toolkit prints branch targets as addresses)."""

import pytest

from horovod_tpu_torch.ops import _build

_HEAD = """
\tcode for sm_90a
\t\tFunction : _Z6kerneli
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
"""


def _sass(*lines):
    return _HEAD + "".join(
        f"        /*{16 * i:04x}*/   {ins} ;   /* 0x000000000000 */\n"
        for i, ins in enumerate(lines))


@pytest.mark.parametrize("lines,want", [
    # A spill before the loop, a reload inside it (0x20..0x40 branches
    # back to 0x20), one after it.
    (("STL [R1], R2", "MOV R3, RZ", "LDL R4, [R1]", "IADD3 R3, R3, 0x1, RZ",
      "@P0 BRA 0x20", "LDL R5, [R1+0x4]", "EXIT"), (3, 1)),
    # A forward branch is no loop.
    (("STL [R1], R2", "@P0 BRA 0x30", "LDL R4, [R1]", "EXIT"), (2, 0)),
    # A spin loop on itself, the spills around it.
    (("STL.64 [R1], R2", "@!P1 BRA.U 0x10", "LDL.64 R2, [R1]", "EXIT"),
     (2, 0)),
    # No spills.
    (("MOV R3, RZ", "@P0 BRA 0x0", "EXIT"), (0, 0)),
], ids=["reload_in_loop", "forward_branch", "spin_loop", "none"])
def test_spill_sites_counts_spills_inside_loops(lines, want):
    assert _build._spill_sites(_sass(*lines)) == {"_Z6kerneli": want}
