"""Wire contracts (protobuf) of the PyTorch port. api_pb2 builds the
messages of api.proto (the JAX package's contract, package dgraph_tpu.api)
in a private descriptor pool; see its docstring. The service stubs are
hand-written in api/grpc_server.py and api/grpc_client.py."""
