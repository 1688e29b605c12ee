"""raytpu_torch.job — job submission; the port of :mod:`raytpu.job`
(reference: dashboard/modules/job/)."""

from raytpu_torch.job.manager import JobInfo, JobManager
from raytpu_torch.job.sdk import JobSubmissionClient
from raytpu_torch.job.server import JobServer

__all__ = ["JobInfo", "JobManager", "JobServer", "JobSubmissionClient"]
