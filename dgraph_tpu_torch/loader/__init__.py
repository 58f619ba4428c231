"""Loaders & export of the PyTorch port: bulk (offline map/reduce), live
(txn batches), xidmap, RDF export. Reference: dgraph/cmd/bulk,
dgraph/cmd/live, xidmap/, worker/export.go."""

from dgraph_tpu_torch.loader.bulk import BulkStats, bulk_load
from dgraph_tpu_torch.loader.export import ExportStats, export_rdf
from dgraph_tpu_torch.loader.live import LiveStats, live_load
from dgraph_tpu_torch.loader.xidmap import XidMap

__all__ = ["BulkStats", "bulk_load", "ExportStats", "export_rdf",
           "LiveStats", "live_load", "XidMap"]
