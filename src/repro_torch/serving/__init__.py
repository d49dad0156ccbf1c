"""Serving engine: continuous batching of the PyTorch model under the
EconoServe scheduler."""
from .engine import (EngineConfig, FleetStalled, GenRequest,
                     InvalidRequestError, RequestShed, ServingEngine)
from .sampling import SamplingParams
