"""The SASS comparison tool (``tools/sass_diff.py``): its parsers of
``cuobjdump -sass`` and ``-Xptxas -v`` output and its verdict, on text in
those tools' formats. The builds and ``cuobjdump`` themselves run on the
machine with the card only."""

import shutil

import pytest

from nerf_and_dietnerf_tpu_torch.tools import sass_diff

SASS = """
	code for sm_90a
		Function : _Z18mlp_fwd_mma_kernel4Dims
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;                    /* 0x0000000000007919 */
        /*0020*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ; /* 0x0000000c0804723c */
		..........

		Function : _Z12forward_tileILb0E13LeakyEpilogueLi2EEv4Dims
        /*0000*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;         /* 0x0000000000007b1d */
        /*0010*/                   RET.REL.NODEC R20 0x0 ;               /* 0x0000000014007950 */
"""
LOG = """--- mlp_fwd
ptxas info    : Compiling entry function '_Z18mlp_fwd_mma_kernel4Dims' for 'sm_90a'
ptxas info    : Function properties for _Z18mlp_fwd_mma_kernel4Dims
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 200 registers, 400 bytes cmem[0]
--- mlp_bwd
ptxas info    : Compiling entry function '_Z18mlp_bwd_mma_kernel4Dims' for 'sm_90a'
ptxas info    : Used 254 registers, 400 bytes cmem[0]
"""


def test_sass_functions_keep_the_instructions_of_each_function():
    funcs = sass_diff.sass_functions(SASS)
    assert list(funcs) == ["_Z18mlp_fwd_mma_kernel4Dims",
                           "_Z12forward_tileILb0E13LeakyEpilogueLi2EEv4Dims"]
    assert funcs["_Z18mlp_fwd_mma_kernel4Dims"] == [
        "LDC R1, c[0x0][0x28]", "S2R R0, SR_TID.X", "HMMA.16816.F32.BF16 R4, R8, R12, R4"]
    assert len(funcs["_Z12forward_tileILb0E13LeakyEpilogueLi2EEv4Dims"]) == 2


def test_ptxas_blocks_hold_the_lines_of_each_library():
    blocks = sass_diff.ptxas_blocks(LOG)
    assert list(blocks) == ["mlp_fwd", "mlp_bwd"]
    assert len(blocks["mlp_fwd"]) == 4 and blocks["mlp_fwd"][-1] == (
        "ptxas info    : Used 200 registers, 400 bytes cmem[0]")
    assert blocks["mlp_bwd"][-1].endswith("Used 254 registers, 400 bytes cmem[0]")


def test_ptxas_entries_read_each_kernels_own_lines():
    """Registers and spills of an entry come from the lines after its own
    "Function properties" line; an entry with none (mlp_bwd here) has none."""
    blocks = sass_diff.ptxas_blocks(LOG)
    assert sass_diff.ptxas_entries(blocks["mlp_fwd"]) == {
        "_Z18mlp_fwd_mma_kernel4Dims": {"spill_stores": 0, "spill_loads": 0, "registers": 200}}
    assert sass_diff.ptxas_entries(blocks["mlp_bwd"]) == {}
    # a device function kept out of line: its lines are not the kernel's
    other = blocks["mlp_fwd"][:1] + [
        "ptxas info    : Function properties for _Z5helperv",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads"]
    assert sass_diff.ptxas_entries(other) == {}


@pytest.mark.parametrize("change", ["none", "renamed", "instruction", "registers", "added"])
def test_compare_names_what_changed(change):
    old = sass_diff.sass_functions(SASS)
    new = {k: list(v) for k, v in old.items()}
    new_log = LOG
    if change == "renamed":  # an out-of-line function whose template arguments changed
        name = "_Z12forward_tileILb0E13LeakyEpilogueLi2EEv4Dims"
        new["_Z12forward_tileILb0EEv4Dims"] = new.pop(name)
    elif change == "instruction":
        new["_Z18mlp_fwd_mma_kernel4Dims"][1] = "S2R R0, SR_TID.Y"
    elif change == "registers":
        new_log = LOG.replace("Used 200 registers", "Used 202 registers")
    elif change == "added":  # a function beside unchanged ones, with ptxas lines of its own
        new["_Z19mlp_fwd_rec_kernel4Dims"] = ["NOP"]
        new_log = LOG.replace("--- mlp_bwd", (
            "ptxas info    : Compiling entry function '_Z19mlp_fwd_rec_kernel4Dims' for "
            "'sm_90a'\nptxas info    : Function properties for _Z19mlp_fwd_rec_kernel4Dims\n"
            "    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
            "ptxas info    : Used 64 registers, 400 bytes cmem[0]\n--- mlp_bwd"))
    line = sass_diff.compare(old, new, LOG, new_log, "mlp_fwd")
    assert line["names_equal"] == (change not in ("renamed", "added"))
    assert line["instructions_equal"] == (change != "instruction")
    assert line["ptxas_equal"] == (change != "registers")
    assert line["same"] == (change in ("none", "renamed", "added"))
    assert line["instructions"] == [5, 5 + (change == "added")]
    assert line["added"] == (["_Z19mlp_fwd_rec_kernel4Dims"] if change == "added" else [])
    assert line["changed"] == (["_Z18mlp_fwd_mma_kernel4Dims"] if change == "instruction"
                               else [])


def test_tool_needs_cuobjdump(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    if sass_diff.Path("/usr/local/cuda/bin/cuobjdump").exists():
        pytest.skip("cuobjdump is installed here")
    assert sass_diff.main([str(tmp_path)]) == 2
    assert "cuobjdump not found" in capsys.readouterr().err
