"""Serving statistics, the step-timeline tracer and the windowed SLO
telemetry of the PyTorch port."""
from .serving import ServingStats
from .slo import (AnomalyDetector, AnomalySpool, SLOConfig, SLOMonitor,
                  WindowedTelemetry)
from .trace import Tracer

__all__ = ["ServingStats", "Tracer", "SLOConfig", "SLOMonitor",
           "WindowedTelemetry", "AnomalyDetector", "AnomalySpool"]
