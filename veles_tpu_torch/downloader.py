"""Downloader unit (the port of ``veles_tpu/downloader.py``): makes sure
a dataset directory exists at ``initialize()``, unpacking an archive
into it when it does not.

Sources are local paths and ``file://`` URLs; an ``http(s)://`` URL is
fetched into ``cache_dir`` (the reference's ``root.common.dirs.cache``)
first.  Zip and tar archives (any compression ``tarfile`` reads) are
unpacked; any other file is copied in.  Only a file this unit fetched
is deleted after unpacking: a local archive stays where it was.
"""

import os
import shutil
import tarfile
import urllib.parse
import urllib.request
import zipfile

from veles_tpu_torch.units import Unit


class Downloader(Unit):
    """Ensures ``directory`` holds ``files``, unpacking ``url`` into it
    if not (ref: veles/downloader.py:56)."""

    VIEW_GROUP = "SERVICE"

    def __init__(self, workflow=None, url=None, directory=None, files=(),
                 cache_dir=None, **kwargs):
        super(Downloader, self).__init__(workflow, **kwargs)
        self.url = url
        self.directory = directory
        #: files expected inside directory (presence check)
        self.files = list(files)
        #: where an http(s) download is written before unpacking (None:
        #: ``root.common.dirs.cache``, as the reference fetches into it)
        self.cache_dir = cache_dir
        self.demand("url", "directory")

    @property
    def _complete(self):
        if not os.path.isdir(self.directory):
            return False
        return all(os.path.exists(os.path.join(self.directory, f))
                   for f in self.files)

    def initialize(self, **kwargs):
        super(Downloader, self).initialize(**kwargs)
        if self._complete:
            self.debug("%s already present", self.directory)
            return
        os.makedirs(self.directory, exist_ok=True)
        archive, fetched = self._fetch()
        try:
            self._unpack(archive)
        finally:
            if fetched:
                try:
                    os.unlink(archive)
                except OSError:
                    pass
        if not self._complete:
            raise RuntimeError(
                "%s: archive did not provide expected files %s"
                % (self, self.files))

    def _fetch(self):
        """(path of the archive, whether this unit downloaded it)."""
        parsed = urllib.parse.urlparse(str(self.url))
        if parsed.scheme in ("", "file"):
            path = parsed.path if parsed.scheme == "file" else self.url
            if not os.path.isfile(path):
                raise FileNotFoundError(path)
            return path, False
        cache = self.cache_dir
        if cache is None:
            from veles_tpu_torch.config import root
            cache = root.common.dirs.get("cache", ".")
        os.makedirs(cache, exist_ok=True)
        target = os.path.join(
            cache, os.path.basename(parsed.path) or "download")
        self.info("downloading %s -> %s", self.url, target)
        with urllib.request.urlopen(self.url) as r, \
                open(target, "wb") as f:
            shutil.copyfileobj(r, f)
        return target, True

    def _unpack(self, archive):
        self.info("unpacking %s -> %s", archive, self.directory)
        if zipfile.is_zipfile(archive):
            with zipfile.ZipFile(archive) as z:
                z.extractall(self.directory)
        elif tarfile.is_tarfile(archive):
            with tarfile.open(archive) as t:
                t.extractall(self.directory, filter="data")
        else:
            shutil.copy(archive, self.directory)

    def run(self):
        pass  # all the work happens at initialize
