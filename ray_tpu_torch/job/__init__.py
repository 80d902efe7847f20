"""Job submission (the counterpart of ``ray_tpu/job/``)."""

from ray_tpu_torch.job.job_manager import (
    JobInfo,
    JobManager,
    JobStatus,
    job_manager,
)

__all__ = ["JobManager", "JobInfo", "JobStatus", "job_manager"]
