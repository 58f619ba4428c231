"""The PyTorch port against tests/test_tls.py: every case, with the port's
modules (workers and Node on device="cpu", the plain PyTorch versions).

Server-side TLS on both API ports (reference x/tls_helper.go surface):
self-signed cert generated at test time, HTTPS + secure-channel gRPC."""

import json
import ssl
import subprocess
import threading
import urllib.request

import pytest

grpc = pytest.importorskip("grpc")

from dgraph_tpu_torch.api.grpc_client import DgraphClient
from dgraph_tpu_torch.api.grpc_server import serve_grpc
from dgraph_tpu_torch.api.http import make_server
from dgraph_tpu_torch.api.server import Node


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tls")
    cert, key = str(d / "cert.pem"), str(d / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "1", "-subj",
         "/CN=localhost", "-addext", "subjectAltName=DNS:localhost"],
        check=True, capture_output=True)
    return cert, key


def test_https_round_trip(certs):
    cert, key = certs
    node = Node(device="cpu")
    node.alter(schema_text="name: string @index(exact) .")
    node.mutate(set_nquads='_:a <name> "tls" .', commit_now=True)
    srv = make_server(node, "localhost", 0, tls_cert=cert, tls_key=key)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        ctx = ssl.create_default_context(cafile=cert)
        body = json.dumps({"query": '{ q(func: eq(name, "tls")) { name } }'})
        r = urllib.request.urlopen(urllib.request.Request(
            f"https://localhost:{port}/query", body.encode(),
            {"Content-Type": "application/json"}), timeout=5, context=ctx)
        out = json.loads(r.read())
        assert out["data"] == {"q": [{"name": "tls"}]}
        # plaintext against the TLS port fails
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://localhost:{port}/health",
                                   timeout=2)
    finally:
        srv.shutdown()


def test_grpc_tls_round_trip(certs):
    cert, key = certs
    node = Node(device="cpu")
    node.alter(schema_text="name: string @index(exact) .")
    server, port = serve_grpc(node, "localhost:0", tls_cert=cert,
                              tls_key=key)
    try:
        creds = grpc.ssl_channel_credentials(
            root_certificates=open(cert, "rb").read())
        chan = grpc.secure_channel(f"localhost:{port}", creds)
        c = DgraphClient(channel=chan)
        assert c.check_version() == "dgraph-tpu"
        c.txn().mutate(set_nquads='_:a <name> "grpc-tls" .', commit_now=True)
        out = c.txn(read_only=True).query(
            '{ q(func: eq(name, "grpc-tls")) { name } }')
        assert out == {"q": [{"name": "grpc-tls"}]}
        c.close()
    finally:
        server.stop(0)
