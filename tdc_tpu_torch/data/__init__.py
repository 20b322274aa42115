"""Dataset generation, loading, streaming, the object-store data plane,
the ingest guard and device-memory-aware batching (counterpart:
tdc_tpu/data; every name of its `__all__` resolves here)."""

from tdc_tpu_torch.data.batching import auto_batch_size, oom_adaptive
from tdc_tpu_torch.data.ingest import IngestPolicy, IngestReport
from tdc_tpu_torch.data.loader import (
    FEATURE_MAJOR_SUFFIX,
    NpzStream,
    batch_iterator,
    crc_sidecar_path,
    load_points,
    load_points_feature_major,
    to_feature_major,
    write_crc_sidecar,
)
from tdc_tpu_torch.data.manifest import Manifest, build_manifest
from tdc_tpu_torch.data.store import ManifestStream, open_manifest_stream
from tdc_tpu_torch.data.synthetic import (
    make_blobs,
    make_classification_data,
    save_npz,
)

__all__ = [
    "FEATURE_MAJOR_SUFFIX",
    "IngestPolicy",
    "IngestReport",
    "Manifest",
    "ManifestStream",
    "NpzStream",
    "auto_batch_size",
    "batch_iterator",
    "build_manifest",
    "crc_sidecar_path",
    "load_points",
    "load_points_feature_major",
    "make_blobs",
    "make_classification_data",
    "oom_adaptive",
    "open_manifest_stream",
    "save_npz",
    "to_feature_major",
    "write_crc_sidecar",
]
