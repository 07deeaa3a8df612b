"""tools/sass_stats.py's reading of `cuobjdump -sass` output, on a fixed
listing (the tool itself runs where the CUDA toolkit is)."""

import subprocess

from kimera_semantics_tpu_torch.tools import sass_stats

LISTING = """
	code for sm_90a
		Function : _Z17proj_apply_kernelILi16EEvPfS0_
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
                                                               /* 0x000fe40000000800 */
        /*0010*/                   MUFU.RCP R3, R2 ;           /* 0x0000000200037308 */
        /*0020*/              @!P0 BRA 0x10 ;                  /* 0x0000000000008947 */
        /*0030*/                   MUFU.RSQ R4, R5 ;           /* 0x0000000500047308 */
        /*0040*/                   MUFU.RCP R6, R7 ;           /* 0x0000000700067308 */
        /*0050*/                   EXIT ;                      /* 0x000000000000794d */
        /*0060*/                   BRA 0x60;                   /* 0xfffffffc00fc7947 */
        /*0070*/                   NOP;                        /* 0x0000000000007918 */
		..........
		Function : _Z16block_rmw_kernelILi2ELi8ELb0ELi512EEv7RmwPtrs
        /*0000*/                   S2R R0, SR_TID.X ;          /* 0x0000000000007919 */
        /*0010*/                   BRA 0x30 ;                  /* 0x0000000000007947 */
        /*0020*/                   NOP;                        /* 0x0000000000007918 */
"""


def test_stats_counts_instructions_mufu_and_loops(monkeypatch):
    def run(cmd, **kw):
        assert cmd[1:] == ["-sass", "lib.so"]
        return subprocess.CompletedProcess(cmd, 0, stdout=LISTING)
    monkeypatch.setattr(sass_stats.subprocess, "run", run)
    monkeypatch.setattr(sass_stats, "cuobjdump", lambda: "cuobjdump")
    got = sass_stats.stats("lib.so")
    assert got == {
        "_Z17proj_apply_kernelILi16EEvPfS0_": dict(
            instructions=7, mufu={"MUFU.RCP": 2, "MUFU.RSQ": 1},
            backward_branches=1),
        "_Z16block_rmw_kernelILi2ELi8ELb0ELi512EEv7RmwPtrs": dict(
            instructions=2, mufu={}, backward_branches=0)}
