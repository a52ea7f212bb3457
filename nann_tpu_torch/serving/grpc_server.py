"""TF-Serving-compatible gRPC Predict front end over the Engine
(nann_tpu/serving/grpc_server.py).

It answers the RPC `/tensorflow.serving.PredictionService/Predict` with
TensorProto payloads, so a stock TF-Serving client works against it:

    stub = prediction_service_pb2_grpc.PredictionServiceStub(channel)
    req = predict_pb2.PredictRequest()
    req.model_spec.name = "nann"
    req.inputs["comm_seq"].CopyFrom(tf.make_tensor_proto(comm_seq, ...))
    req.inputs["level_topn"].CopyFrom(tf.make_tensor_proto(level_topn, ...))
    resp = stub.Predict(req)         # outputs: top_k [B,k], scores [B,k]

The wire messages are coded by hand (`tfs_proto.py`), so the serving process
never imports tensorflow, and the RPC is registered through grpc's generic
handler API (no generated stubs). `grpc` is imported only when a server or
client is made. Micro-batching, deadlines and rejection are the engine's, as
behind the REST front end (`server.py`).
"""

from __future__ import annotations

import logging
from concurrent import futures
from typing import Optional

import numpy as np

from . import tfs_proto
from .engine import Engine, RequestRejected

logger = logging.getLogger("nann_tpu_torch.grpc")

SERVICE = "tensorflow.serving.PredictionService"


class NannGrpcServer:
    """gRPC PredictionService over an Engine.

    Takes `comm_seq` as fp16/fp32 `[L*d]`, `[1, L*d]`, `[B, L*d]` or
    `[B, L, d]` and an optional `level_topn` int32 vector shared by the
    batch. Each row is submitted to the engine on its own: rows of concurrent
    RPCs batch together in the engine's dispatcher.
    """

    def __init__(self, engine: Engine, host: str = "127.0.0.1",
                 port: int = 8500, model_name: str = "nann",
                 max_workers: int = 16):
        import grpc  # an optional dependency

        self.engine = engine
        self.model_name = model_name
        handler = grpc.method_handlers_generic_handler(SERVICE, {
            "Predict": grpc.unary_unary_rpc_method_handler(
                self._predict,
                request_deserializer=tfs_proto.decode_predict_request,
                response_serializer=lambda outs: (
                    tfs_proto.encode_predict_response(outs, model_name)),
            ),
        })
        self._grpc = grpc
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(f"{host}:{port}")

    # ------------------------------------------------------------ handlers

    def _predict(self, request, context):
        _spec, inputs = request
        grpc = self._grpc
        if "comm_seq" not in inputs:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "input 'comm_seq' required")
        mcfg = self.engine.mcfg
        L, d = mcfg.max_seq_length, mcfg.user_emb_dim
        try:
            comm = np.asarray(inputs["comm_seq"], np.float32)
            if comm.size % (L * d):
                raise ValueError(
                    f"comm_seq size {comm.size} not a multiple of "
                    f"L*d={L}*{d}")
            comm = comm.reshape(-1, L, d)
            if comm.shape[0] == 0:
                raise ValueError("empty comm_seq")
            ltn: Optional[np.ndarray] = None
            if "level_topn" in inputs:
                ltn = np.asarray(inputs["level_topn"], np.int32).reshape(-1)
        except (ValueError, TypeError) as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"bad inputs: {e}")
        futs = [self.engine.submit(row, ltn) for row in comm]
        items, scores = [], []
        try:
            for f in futs:
                it, sc = f.result(timeout=30)
                items.append(np.asarray(it, np.int32))
                scores.append(np.asarray(sc, np.float32))
        except RequestRejected as e:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except Exception as e:  # noqa: BLE001
            context.abort(grpc.StatusCode.INTERNAL, str(e))
        # rows may differ in length (invalid slots stripped): pad to the
        # longest with id 0 and score -inf
        k = max(x.size for x in items)
        top_k = np.zeros((len(items), k), np.int32)
        out_sc = np.full((len(items), k), -np.inf, np.float32)
        for i, (it, sc) in enumerate(zip(items, scores)):
            top_k[i, :it.size] = it
            out_sc[i, :sc.size] = sc
        return {"top_k": top_k, "scores": out_sc}

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._server.start()
        logger.info("gRPC PredictionService on :%d", self.port)

    def stop(self, grace: float = 1.0) -> None:
        self._server.stop(grace).wait()


def make_client_call(channel, model_name: str = "nann"):
    """A callable(inputs: dict[str, np.ndarray], timeout) -> outputs dict
    that speaks the TF-Serving Predict protocol over a grpc channel."""
    method = channel.unary_unary(
        f"/{SERVICE}/Predict",
        request_serializer=lambda inputs: (
            tfs_proto.encode_predict_request(inputs, model_name)),
        response_deserializer=tfs_proto.decode_predict_response,
    )

    def call(inputs, timeout: float = 30.0):
        _spec, outputs = method(inputs, timeout=timeout)
        return outputs

    return call
