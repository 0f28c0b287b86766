"""The per-phase time limit of ``suite_settings.py`` fails a test that overruns it,
with a message that names the limit, instead of letting it run on."""

import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path


def test_a_test_past_its_limit_fails_with_the_limit_message(tmp_path):
    shutil.copy(Path(__file__).with_name("suite_settings.py"), tmp_path)
    (tmp_path / "test_overrun.py").write_text(
        "import time\n"
        "import pytest\n\n\n"
        "@pytest.mark.timeout(2)\n"
        "def test_overrun():\n"
        "    time.sleep(60)\n")
    report = tmp_path / "report.xml"
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "suite_settings", f"--junitxml={report}", "test_overrun.py"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1, res.stdout + res.stderr
    assert "call exceeded the time limit of 2 s" in res.stdout, res.stdout
    (case,) = ET.parse(report).getroot().iter("testcase")
    assert case.find("failure") is not None
    assert 2.0 <= float(case.get("time")) < 10.0
