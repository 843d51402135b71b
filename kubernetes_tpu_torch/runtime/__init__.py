"""The TPUScore sidecar's server side (sidecar.py), the proto <-> object
conversion (convert.py) and the wire (tpuscore.proto, tpuscore_pb2.py, the
JAX package's byte for byte).  Nothing is imported here: the engine
(sidecar._Engine, _Session) works without grpc or protobuf installed."""
