"""K7 and the scatter-strategy profiling tool (kimera_semantics_tpu_torch/
ops/kernels.py add_f32, tools/profile_scatter.py) against the reference
(CPU): K7's plain version against the `_add` Pallas kernel of
scripts/profile_scatter_r4.py:103-110, run here in interpret mode, on
seeded (8, 128) float32 inputs; the tool at its --smoke size, every
strategy against one reference scatter; its probes.

Tolerances: K7 bit-exact (one float32 add per element on both sides); the
tool's channels exact (every segment value is 1 or 0.5, so the sums are
exact in any order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from kimera_semantics_tpu_torch.ops import kernels
from kimera_semantics_tpu_torch.tools import profile_scatter as ps


def _add(x_ref, y_ref, o_ref):
    # The body of scripts/profile_scatter_r4.py:103-104.
    o_ref[:] = x_ref[:] + y_ref[:]


def test_k7_plain_matches_pallas_add():
    rng = np.random.RandomState(7)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    y = rng.standard_normal((8, 128)).astype(np.float32) * 1e3
    ref = pl.pallas_call(
        _add, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        compiler_params=pltpu.CompilerParams(
            vmem_limit_bytes=100 * 1024 * 1024),
        interpret=True)(jnp.asarray(x), jnp.asarray(y))
    got = kernels.add_f32_plain(torch.tensor(x), torch.tensor(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # The wrapper takes the plain version for CPU tensors and counts no
    # launch.
    kernels.reset_launches()
    again = kernels.add_f32(torch.tensor(x), torch.tensor(y))
    assert torch.equal(again, got) and kernels.launches["add_f32"] == 0


def test_k7_wrapper_checks():
    with pytest.raises(ValueError):
        kernels.add_f32(torch.ones(4, device="meta"), torch.ones(4,
                                                               device="meta"))


def check_against_reference(res):
    ref = ps.reference(res["segments"])
    k = res["frames"] + 1
    assert set(res["channels"]) == set(ps.STRATEGIES)
    for name, chans in res["channels"].items():
        assert tuple(chans) == ps.CHANNELS[name]
        for c, t in chans.items():
            assert torch.equal(t, k * ref[c]), (name, c)
        assert res["ms"][name] > 0


def test_tool_smoke_matches_reference_scatter():
    lines = []
    res = ps.run(frames=2, smoke=True, device="cpu", warm_kernel=True,
                 log=lines.append)
    check_against_reference(res)
    assert "warm: K7 add_f32 (8, 128) ran" in lines
    seg = res["segments"]
    assert (seg["cap"], seg["v3"], seg["B"], seg["nseg"]) == (512, 512,
                                                              1 << 14, 1200)
    assert int(seg["seg_valid"].sum()) == 1200


@pytest.mark.parametrize("mode", ps.WARM_MODES)
def test_tool_warm_modes(mode):
    lines = []
    ps.warm_up(mode, True, torch.device("cpu"), lines.append)
    assert lines == [f"warm: mode={mode} ran"]


def test_tool_cli(capsys):
    assert ps.main(["--smoke", "--device", "cpu", "--frames", "1",
                    "--ballast-gb", "0.01", "--warm-pipe"]) == 0
    out = capsys.readouterr().out
    assert "ballast: 0.01 GiB" in out and "2 real fast frames" in out
    assert "every strategy's channels equal 2 x" in out
    with pytest.raises(SystemExit):
        ps.main(["--warm-mode", "nope"])
    if not torch.cuda.is_available():
        # The tool runs on the card unless asked for the CPU.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ps.run(frames=1, smoke=True)
