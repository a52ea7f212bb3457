"""The serving engine, its metrics, its front ends (REST, gRPC), the model
reloader and selector, the engine pool and the load generator."""

from .metrics import Histogram, Meter, MetricsRegistry
from .engine import Engine, EngineConfig, RequestRejected
from .server import NannServer
from .grpc_server import NannGrpcServer
from .load_gen import LoadGenConfig, run_load_test
from .pool import EnginePool
from .selector import ModelReloader, ModelSelector

__all__ = ["Engine", "EngineConfig", "RequestRejected", "NannServer",
           "Histogram", "Meter", "MetricsRegistry", "LoadGenConfig",
           "run_load_test", "EnginePool", "ModelReloader", "ModelSelector"]
