"""The card's line, frozen from nvdiffrecmc_tpu_torch/bench_common.py at
commit 33f28f5 (smi_line, unchanged), and its power limit as a number.
The benchmark takes device times from its own reading of the profiler's
trace (profile.py), so bench_common's events_ms and device_ms are not
copied."""

import subprocess


def smi_line():
    """nvidia-smi's name and power limit of the first card, one line."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def power_limit_w():
    """The first card's power limit in watts, or None where nvidia-smi
    does not say."""
    try:
        return float(smi_line().split(',')[-1].strip().split()[0])
    except (OSError, subprocess.CalledProcessError, ValueError, IndexError):
        return None
