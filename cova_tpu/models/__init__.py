from cova_tpu.models.blobnet import BlobNet, BlobNetConfig  # noqa: F401
