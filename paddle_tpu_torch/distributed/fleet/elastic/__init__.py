"""Elastic training manager over the port's TCPStore (counterpart of
paddle_tpu/distributed/fleet/elastic): nodes heartbeat a lease key; the
watch thread detects joins and leaves from lease expiry and flips the
manager into NEED_LAUNCH, which the launch controller consumes to restart
the job with the surviving node set."""
from .manager import ElasticManager, ElasticStatus

__all__ = ["ElasticManager", "ElasticStatus"]
