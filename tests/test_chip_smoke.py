"""chip_smoke.py's own helpers, and its refusal to run without a GPU."""

import numpy as np
import pytest

import chip_smoke


def test_eq_accepts_identical_trees():
    a = {"x": np.arange(4, dtype=np.int32), "y": (np.ones(2, bool),)}
    chip_smoke._eq("same", a, {"x": np.arange(4, dtype=np.int32),
                               "y": (np.ones(2, bool),)})


@pytest.mark.parametrize("other", [
    np.array([0, 1, 2, 4], np.int32),     # a value differs
    np.arange(4, dtype=np.int64),         # dtype differs
    np.arange(5, dtype=np.int32),         # shape differs
])
def test_eq_rejects_any_difference(other):
    with pytest.raises(AssertionError):
        chip_smoke._eq("diff", np.arange(4, dtype=np.int32), other)


def test_mask_to_xy_is_row_major_xy():
    mask = np.zeros((4, 5), bool)
    mask[1, 3] = mask[0, 4] = mask[3, 0] = True
    np.testing.assert_array_equal(chip_smoke._mask_to_xy(mask),
                                  [[4, 0], [3, 1], [0, 3]])


def test_refuses_to_run_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""  # no result line


def test_main_path_imports_neither_pil_nor_orbax():
    """Pillow and orbax are not on the card's machine: the smoke run,
    the bench, the CLI and the modules they reach must not import them."""
    import os
    import subprocess
    import sys

    code = (
        "import sys, chip_smoke, bench\n"
        "from feature_detector_fast_tpu import api, cli, serving\n"
        "from feature_detector_fast_tpu.models import brief, match, slam\n"
        "from feature_detector_fast_tpu.parallel import (\n"
        "    ba_sharded, frontend, multihost, pipeline)\n"
        "from feature_detector_fast_tpu.utils import image\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('PIL', 'orbax'))\n"
        "assert not bad, bad\n"
    )
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
