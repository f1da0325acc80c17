"""HDFS text loader (the port of ``veles_tpu/loader/hdfs_loader.py``;
ref: veles/loader/hdfs_loader.py:48).

The reference streamed newline-delimited text records from HDFS for the
Mastodon bridge; this implementation speaks **WebHDFS** (the REST
gateway every Hadoop distribution ships) via urllib — no Java client
needed.  Records are parsed by a pluggable ``parse(line) -> (features,
label)`` callable (default: whitespace-separated floats, last column =
label)."""

import json
import urllib.parse
import urllib.request

import numpy

from veles_tpu_torch.loader.fullbatch import FullBatchLoader


def default_parse(line):
    parts = line.split()
    return [float(v) for v in parts[:-1]], parts[-1]


class WebHDFSClient:
    """Minimal WebHDFS API (LISTSTATUS + OPEN)."""

    def __init__(self, namenode, user=None, timeout=30):
        self.base = "http://%s/webhdfs/v1" % namenode
        self.user = user
        self.timeout = timeout

    def _url(self, path, op, **params):
        q = {"op": op}
        if self.user:
            q["user.name"] = self.user
        q.update(params)
        return "%s%s?%s" % (self.base, path, urllib.parse.urlencode(q))

    def listdir(self, path):
        with urllib.request.urlopen(self._url(path, "LISTSTATUS"),
                                    timeout=self.timeout) as r:
            statuses = json.load(r)["FileStatuses"]["FileStatus"]
        return [(s["pathSuffix"], s["type"]) for s in statuses]

    def read(self, path):
        with urllib.request.urlopen(self._url(path, "OPEN"),
                                    timeout=self.timeout) as r:
            return r.read()


class HDFSTextLoader(FullBatchLoader):
    """Reads every file under the class paths and parses lines into
    (features, label) rows (ref: hdfs_loader.py:48)."""

    def __init__(self, workflow, namenode=None, user=None,
                 test_path=None, validation_path=None, train_path=None,
                 parse=default_parse, **kwargs):
        super(HDFSTextLoader, self).__init__(workflow, **kwargs)
        if namenode is None:
            raise ValueError("namenode host:port is required")
        self.namenode = namenode
        self.user = user
        self.class_paths = [test_path, validation_path, train_path]
        self.parse = parse

    def _files_under(self, client, path):
        out = []
        for suffix, kind in client.listdir(path):
            full = path.rstrip("/") + "/" + suffix if suffix else path
            if kind == "DIRECTORY":
                out.extend(self._files_under(client, full))
            else:
                out.append(full)
        return sorted(out)

    def load_data(self):
        client = WebHDFSClient(self.namenode, self.user)
        rows, labels = [], []
        for ci, path in enumerate(self.class_paths):
            count = 0
            if path:
                for f in self._files_under(client, path):
                    text = client.read(f).decode()
                    for line in text.splitlines():
                        line = line.strip()
                        if not line:
                            continue
                        feats, label = self.parse(line)
                        rows.append(feats)
                        labels.append(label)
                        count += 1
            self.class_lengths[ci] = count
        if not rows:
            raise ValueError("%s: no records under %s" %
                             (self, self.class_paths))
        self.original_data = numpy.asarray(rows, numpy.float32)
        if any(l is not None for l in labels):
            # original_labels stays RAW — fullbatch._post_load applies
            # labels_mapping (pre-mapping would double-map to -1)
            self.original_labels = labels
            if not all(isinstance(l, (int, numpy.integer))
                       for l in labels):
                self.labels_mapping = {
                    l: i for i, l in enumerate(sorted(set(labels)))}
