"""Loaders & export of the PyTorch port. Only the RDF export is ported
(worker/export.go); the bulk and live loaders and the xid map wait for the
loaders slice."""

from dgraph_tpu_torch.loader.export import ExportStats, export_rdf

__all__ = ["ExportStats", "export_rdf"]
