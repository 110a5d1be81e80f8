"""Data routing: local image files / .npy point clouds, plus the
reference's ceph/petrel ``s3://`` object-store route
(model/accessory/data/data_reader.py:7-28) behind a pluggable client.

The petrel SDK isn't installed in most environments, so the client is
lazy: first ``s3://`` read tries ``petrel_client`` (the reference's
dependency), unless a custom client was registered with
``set_object_store_client`` (anything with a ``get(path) -> bytes``
method). Local paths never touch the client.
"""

from __future__ import annotations

from io import BytesIO

import numpy as np
from PIL import Image

# NOTE: the reference sets Image.MAX_IMAGE_PIXELS = None process-wide
# (data_reader.py:4); we deliberately KEEP PIL's decompression-bomb guard —
# one adversarial PNG in an untrusted task JSON would otherwise allocate
# unbounded memory. Callers with legitimately huge images can raise the
# limit themselves.

_client = None


def set_object_store_client(client) -> None:
    """Register an object-store client: any object with
    ``get(path) -> bytes`` (the petrel Client interface)."""
    global _client
    _client = client


def _init_ceph_client_if_needed():
    """Lazy petrel init, matching the reference's one-shot global
    (data_reader.py:19-27)."""
    global _client
    if _client is None:
        from petrel_client.client import Client  # noqa: F401

        _client = Client("~/petreloss.conf")
    return _client


def read_img_general(img_path: str):
    if img_path.endswith(".npy"):
        return np.load(img_path)
    if "s3://" in img_path:
        client = _init_ceph_client_if_needed()
        img_bytes = client.get(img_path)
        return Image.open(BytesIO(img_bytes)).convert("RGB")
    return Image.open(img_path).convert("RGB")
