"""publishing — end-of-train report generation (the port of
``veles_tpu/publishing``; rebuild of veles/publishing/: Publisher unit
+ pluggable backends).

The backends render the Publisher's payload — the port's
``gather_results``, ``checksum``, ``generate_graph`` and plotter
payloads — to Markdown, HTML (plot images through
``graphics_client.render_payload`` where matplotlib is installed),
a Jupyter notebook, LaTeX (and a PDF where a TeX engine is on PATH)
and a Confluence page over its REST API (settings from the backend's
arguments, else ``root.common.publishing.confluence``).
"""

from veles_tpu_torch.publishing.publisher import Publisher  # noqa: F401
from veles_tpu_torch.publishing.backends import (  # noqa: F401
    BACKENDS, ConfluenceBackend, HTMLBackend, LaTeXBackend,
    MarkdownBackend, NotebookBackend)
