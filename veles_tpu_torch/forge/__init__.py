"""forge — the model hub (the port of ``veles_tpu/forge``; rebuild of
veles/forge/): share trained model packages (the package_export
archive format, which both packages read) through a central server
with versioning.  The wire is the reference's, so either package's
client talks to either's server."""

from veles_tpu_torch.forge.client import (  # noqa: F401
    fetch, list_packages, upload, versions)
from veles_tpu_torch.forge.server import ForgeServer, ForgeStore  # noqa: F401
