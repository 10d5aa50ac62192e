"""chip_smoke.py refuses to report success without a GPU or without the
program beside it."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On the CPU, and copied into a directory with nothing else of the
    repository, the script exits non-zero and never prints a result."""
    script = SCRIPT
    if alone:
        script = tmp_path / "chip_smoke.py"
        shutil.copy(SCRIPT, script)
    proc = _run(script, tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    if not alone:
        assert "no GPU" in proc.stdout
