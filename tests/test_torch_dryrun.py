"""The port's multi-device dry run (``emqx_tpu_torch/parallel/dryrun.py``)
run through to its end on ``[cpu] * n``, and held to the reference's
(``__graft_entry__.dryrun_multichip`` on the eight virtual CPU devices of
``tests/conftest.py``).

Both make the same workload from the same seed (1,500 filters, 4,096
topics, 16 ``$share`` groups), so the match count, the mesh shapes, the
ring's rows, the EP overflow and parity rows and the Ulysses slices
agree; the subscriber sets differ (the reference draws them from the
process's string hash, the port from crc32), so the selected and
delivered counts are the port's own, each checked by the run against
its host oracles."""

import re

import pytest
import torch

import __graft_entry__ as graft
from emqx_tpu_torch.parallel import dryrun

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def reference_lines():
    """The reference dry run's printed lines on eight devices."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        graft.dryrun_multichip(8)
    return [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("dryrun")]


def _fields(line):
    return dict(re.findall(r"(\w+)=([^,\s]+(?: \([^)]*\))?)", line))


def test_dryrun_on_eight_cpu_positions_equals_reference(reference_lines,
                                                        capsys):
    out = dryrun.dryrun_multichip([CPU] * 8)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("dryrun")]
    assert len(lines) == len(reference_lines) == 5
    own = {"selected", "deliveries"}   # depend on the subscriber sets
    for got, want in zip(lines, reference_lines):
        assert got.split(":")[0] == want.split(":")[0]
        g, w = _fields(got), _fields(want)
        assert g.keys() == w.keys()
        assert {k: v for k, v in g.items() if k not in own} == \
            {k: v for k, v in w.items() if k not in own}, (got, want)
    assert out["config2_3"]["mesh"] == {"dp": 2, "tp": 4}
    assert (out["config5"]["ring"], out["ep"]["parts"], out["ulysses"]["u"]) \
        == (4, 4, 8)
    assert out["ep"]["parity_checked"] > 0 and out["config4"]["selected"] > 0


def test_dryrun_mesh_rules_on_two_positions(capsys):
    """Two devices: tp = 2, a ring of 2, two partitions, u = 2, as the
    reference's rules give (``pick_shape``, ``max(2, n // dp)``, 4 if n
    >= 4 else 2, the largest power of two)."""
    out = dryrun.dryrun_multichip(["cpu"] * 2, verbose=False)
    assert out["config2_3"]["mesh"] == {"dp": 1, "tp": 2}
    assert (out["config5"]["ring"], out["ep"]["parts"], out["ulysses"]["u"]) \
        == (2, 2, 2)
    assert out["config2_3"]["matches"] > 0
    assert capsys.readouterr().out == ""


def test_dryrun_without_a_card_and_without_devices_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_multichip()
