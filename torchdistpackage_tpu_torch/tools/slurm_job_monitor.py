"""SLURM job babysitter — the port's
``torchdistpackage_tpu/tools/slurm_job_monitor.py`` (the reference's
``torchdistpackage/tools/slurm_job_monitor.py``, its one elastic
fault-recovery mechanism): submit an sbatch job, poll ``sacct`` for its
state, cancel anything dead or stuck, and resubmit until the job reaches
COMPLETED.

The script it submits is expected to start the port on each host
(``dist.setup_distributed`` reads the SLURM environment).  Plain
``subprocess`` work with no device, so it runs on a login node:

    python -m torchdistpackage_tpu_torch.tools.slurm_job_monitor job.sbatch \
        [sbatch args...]
"""

from __future__ import annotations

import re
import subprocess
import time
from typing import Optional, Sequence

# sacct states that mean "keep waiting".
_LIVE_STATES = ("RUNNING", "PENDING", "REQUEUED", "RESIZING", "SUSPENDED")
_DONE_STATE = "COMPLETED"


def _run(cmd: Sequence[str]) -> str:
    return subprocess.run(
        list(cmd), check=True, capture_output=True, text=True
    ).stdout


def launch_job(sbatch_script: str, *sbatch_args: str) -> str:
    """Submit ``sbatch_script`` and return the job id.

    The reference's ``launch_job`` (slurm_job_monitor.py:24-40).
    """
    out = _run(["sbatch", *sbatch_args, sbatch_script])
    m = re.search(r"Submitted batch job (\d+)", out)
    if not m:
        raise RuntimeError(f"could not parse job id from sbatch output: {out!r}")
    return m.group(1)


def get_job_state(job_id: str) -> Optional[str]:
    """Primary sacct state for a job id.  None while sacct has no record yet
    — or when sacct itself errors (slurmdbd hiccup): the babysitter must
    survive transient control-plane failures, so those read as "unknown",
    not as a crash."""
    try:
        out = _run(["sacct", "-j", job_id, "--format=JobID,State", "--noheader", "-X"])
    except (subprocess.CalledProcessError, OSError):
        return None
    for line in out.splitlines():
        parts = line.split()
        if len(parts) >= 2 and parts[0] == job_id:
            return parts[1].rstrip("+")
    return None


def determine_job_is_alive(job_id: str) -> bool:
    """True while the job is running or queued — the reference's
    ``determine_job_is_alive`` (slurm_job_monitor.py:55-75)."""
    state = get_job_state(job_id)
    return state is None or state in _LIVE_STATES


def cancel_job(job_id: str) -> None:
    subprocess.run(["scancel", job_id], check=False)


def monitor_job(
    sbatch_script: str,
    *sbatch_args: str,
    poll_interval_s: float = 60.0,
    max_relaunches: Optional[int] = None,
) -> str:
    """Babysit a job to completion: launch, poll, and on any dead state
    (FAILED / NODE_FAIL / TIMEOUT / CANCELLED / ...) cancel + resubmit, until
    sacct reports COMPLETED.  Returns the final (successful) job id.

    The reference's ``monitor_job`` (slurm_job_monitor.py:97-122).
    ``max_relaunches=None`` retries forever, like the reference.
    """
    relaunches = 0
    job_id = launch_job(sbatch_script, *sbatch_args)
    print(f"[slurm-monitor] launched job {job_id}")
    while True:
        time.sleep(poll_interval_s)
        state = get_job_state(job_id)
        if state == _DONE_STATE:
            print(f"[slurm-monitor] job {job_id} COMPLETED")
            return job_id
        if state is None or state in _LIVE_STATES:
            continue
        print(f"[slurm-monitor] job {job_id} state={state} — relaunching")
        cancel_job(job_id)
        if max_relaunches is not None and relaunches >= max_relaunches:
            raise RuntimeError(
                f"job failed {relaunches + 1} times (last state {state}); giving up"
            )
        # one dead job consumes exactly one relaunch from the budget; a failed
        # *submission* (transient sbatch/control-plane outage) retries below
        # without consuming more — otherwise an outage while a job is down
        # would burn the whole budget with zero real job failures.
        relaunches += 1
        while True:
            try:
                job_id = launch_job(sbatch_script, *sbatch_args)
                break
            except (subprocess.CalledProcessError, OSError, RuntimeError) as e:
                print(f"[slurm-monitor] relaunch submission failed ({e}); retrying")
                time.sleep(poll_interval_s)
        print(f"[slurm-monitor] relaunched as job {job_id}")


if __name__ == "__main__":
    import sys

    if len(sys.argv) < 2:
        print("usage: python -m torchdistpackage_tpu_torch.tools.slurm_job_monitor <sbatch_script> [sbatch args...]")
        raise SystemExit(2)
    monitor_job(sys.argv[1], *sys.argv[2:])
