"""Report rendering backends (the port of
``veles_tpu/publishing/backends.py``; rebuild of
veles/publishing/*_backend.py + registry.py).  Each backend renders the
Publisher's payload dict to a file and returns its path."""

import json
import os


def _slug(name):
    return "".join(c if c.isalnum() else "_" for c in name).lower()


def _metrics_rows(metrics):
    return [(k, v) for k, v in sorted(metrics.items())]


class MarkdownBackend:
    """ref: publishing/markdown_backend.py role."""

    NAME = "markdown"
    EXT = ".md"

    def render(self, payload, out_dir):
        lines = ["# %s" % payload["title"], "",
                 "- workflow: `%s` (%s)" % (payload["workflow"],
                                            payload["workflow_class"]),
                 "- generated: %s" % payload["generated"],
                 "- checksum: `%s`" % payload["checksum"][:16], "",
                 "## Metrics", "",
                 "| metric | value |", "|---|---|"]
        for k, v in _metrics_rows(payload["metrics"]):
            lines.append("| %s | %s |" % (k, v))
        lines += ["", "## Unit timings", "",
                  "| unit | class | runs | seconds |", "|---|---|---|---|"]
        for u in payload["units"]:
            lines.append("| %s | %s | %d | %.4f |"
                         % (u["name"], u["class"], u["runs"],
                            u["seconds"]))
        if payload.get("plots"):
            lines += ["", "## Plots", ""]
            for name, plot in sorted(payload["plots"].items()):
                lines.append("- **%s** (%s)" % (name, plot.get("kind")))
        lines += ["", "## Workflow graph", "", "```dot",
                  payload["graph_dot"], "```", ""]
        path = os.path.join(out_dir,
                            _slug(payload["workflow"]) + "_report.md")
        with open(path, "w") as f:
            f.write("\n".join(lines))
        return path


class HTMLBackend:
    """Standalone HTML page; plots render as PNGs beside it when
    matplotlib is available.  When they cannot be rendered the page
    lands without them, as the reference's does, and
    :attr:`images_skipped` says why (None when every plot rendered)."""

    NAME = "html"
    EXT = ".html"

    def __init__(self):
        #: the PNGs written by the last render
        self.images = []
        #: why the last render wrote no images (None: it wrote them all)
        self.images_skipped = None

    def render(self, payload, out_dir):
        imgs = []
        self.images_skipped = None
        try:
            from veles_tpu_torch.graphics_client import render_payload
            for name, plot in sorted(payload.get("plots", {}).items()):
                png = os.path.join(
                    out_dir, "%s_%s.png" % (_slug(payload["workflow"]),
                                            _slug(name)))
                render_payload(plot).savefig(png)
                imgs.append((name, os.path.basename(png)))
        except Exception as e:  # plots are garnish; the report must land
            imgs = []
            self.images_skipped = "%s: %s" % (type(e).__name__, e)
            import logging
            logging.getLogger("HTMLBackend").warning(
                "plot images skipped (%s)", self.images_skipped)
        self.images = [os.path.join(out_dir, src) for _, src in imgs]
        rows = "".join("<tr><td>%s</td><td>%s</td></tr>" % kv
                       for kv in _metrics_rows(payload["metrics"]))
        figures = "".join(
            '<figure><img src="%s" alt="%s"/><figcaption>%s'
            "</figcaption></figure>" % (src, name, name)
            for name, src in imgs)
        html = (
            "<!DOCTYPE html><html><head><meta charset='utf-8'>"
            "<title>%s</title></head><body><h1>%s</h1>"
            "<p>%s — generated %s</p>"
            "<h2>Metrics</h2><table>%s</table>%s</body></html>"
            % (payload["title"], payload["title"], payload["workflow"],
               payload["generated"], rows, figures))
        path = os.path.join(out_dir,
                            _slug(payload["workflow"]) + "_report.html")
        with open(path, "w") as f:
            f.write(html)
        return path


class NotebookBackend:
    """Jupyter notebook (ref: publishing/ipython_backend.py role): one
    markdown summary cell + a code cell reloading the metrics."""

    NAME = "notebook"
    EXT = ".ipynb"

    def render(self, payload, out_dir):
        md = ["# %s\n" % payload["title"],
              "%s — generated %s\n" % (payload["workflow"],
                                       payload["generated"]),
              "\n## Metrics\n"]
        md += ["- **%s**: %s\n" % kv
               for kv in _metrics_rows(payload["metrics"])]
        nb = {
            "nbformat": 4, "nbformat_minor": 5,
            "metadata": {"language_info": {"name": "python"}},
            "cells": [
                {"cell_type": "markdown", "metadata": {}, "source": md},
                {"cell_type": "code", "metadata": {},
                 "execution_count": None, "outputs": [],
                 "source": ["metrics = %r\n" % payload["metrics"],
                            "metrics\n"]},
            ],
        }
        path = os.path.join(out_dir,
                            _slug(payload["workflow"]) + "_report.ipynb")
        with open(path, "w") as f:
            json.dump(nb, f, indent=1, default=str)
        return path


class LaTeXBackend:
    """LaTeX article + PDF when a TeX engine is on PATH (ref:
    publishing/pdf_backend.py role — the reference shelled out to an
    external renderer too).  Without TeX the ``.tex`` artifact is the
    deliverable."""

    NAME = "latex"
    EXT = ".tex"

    @staticmethod
    def _esc(s):
        out = []
        for ch in str(s):
            if ch in "&%$#_{}":
                out.append("\\" + ch)
            elif ch == "\\":
                out.append(r"\textbackslash{}")
            elif ch == "~":
                out.append(r"\textasciitilde{}")
            elif ch == "^":
                out.append(r"\textasciicircum{}")
            else:
                out.append(ch)
        return "".join(out)

    def render(self, payload, out_dir):
        e = self._esc
        lines = [
            r"\documentclass{article}",
            r"\usepackage{booktabs}",
            r"\usepackage{graphicx}",
            r"\title{%s}" % e(payload["title"]),
            r"\date{%s}" % e(payload["generated"]),
            r"\begin{document}",
            r"\maketitle",
            r"\noindent workflow: \texttt{%s} (%s); checksum "
            r"\texttt{%s}" % (e(payload["workflow"]),
                              e(payload["workflow_class"]),
                              e(payload["checksum"][:16])),
            r"\section*{Metrics}",
            r"\begin{tabular}{ll}", r"\toprule",
            r"metric & value \\", r"\midrule",
        ]
        for k, v in _metrics_rows(payload["metrics"]):
            lines.append(r"%s & %s \\" % (e(k), e(v)))
        lines += [r"\bottomrule", r"\end{tabular}",
                  r"\section*{Unit timings}",
                  r"\begin{tabular}{llrr}", r"\toprule",
                  r"unit & class & runs & seconds \\", r"\midrule"]
        for u in payload["units"]:
            lines.append(r"%s & %s & %d & %.4f \\"
                         % (e(u["name"]), e(u["class"]), u["runs"],
                            u["seconds"]))
        lines += [r"\bottomrule", r"\end{tabular}"]
        if payload.get("plots"):
            lines += [r"\section*{Plots}", r"\begin{itemize}"]
            lines += [r"\item \textbf{%s} (%s)"
                      % (e(name), e(plot.get("kind")))
                      for name, plot in sorted(payload["plots"].items())]
            lines += [r"\end{itemize}"]
        lines += [r"\end{document}", ""]
        path = os.path.join(out_dir,
                            _slug(payload["workflow"]) + "_report.tex")
        with open(path, "w") as f:
            f.write("\n".join(lines))
        return self._try_pdf(path, out_dir) or path

    @staticmethod
    def _try_pdf(tex_path, out_dir):
        import shutil
        import subprocess
        for engine in ("tectonic", "pdflatex", "xelatex"):
            exe = shutil.which(engine)
            if not exe:
                continue
            args = [exe, tex_path] if engine == "tectonic" else \
                [exe, "-interaction=nonstopmode",
                 "-output-directory", out_dir, tex_path]
            try:
                subprocess.run(args, cwd=out_dir, capture_output=True,
                               timeout=120, check=True)
            except Exception:
                continue  # this engine failed; try the next one
            pdf = os.path.splitext(tex_path)[0] + ".pdf"
            if os.path.isfile(pdf):
                return pdf
        return None


class ConfluenceBackend:
    """Publish the report as a Confluence page (ref:
    publishing/confluence_backend.py + confluence.py — the reference
    logged in over XML-RPC and stored storage-format content; this
    rebuild targets the REST API: POST /rest/api/content with
    storage-format XHTML).  Configuration comes from the backend
    kwargs/config: ``server``, ``space``, ``token`` (or
    ``username``/``password``), optional ``page`` title and ``parent``
    page id.  Also writes the page XHTML beside the snapshots so the
    report survives an unreachable server."""

    NAME = "confluence"
    EXT = ".xhtml"

    def __init__(self, server=None, space=None, token=None,
                 username=None, password=None, page=None, parent=None,
                 timeout=30):
        from veles_tpu_torch.config import root
        cfg = root.common.publishing.confluence
        self.server = server or cfg.get("server")
        self.space = space or cfg.get("space")
        self.token = token or cfg.get("token")
        self.username = username or cfg.get("username")
        self.password = password or cfg.get("password")
        self.page = page or cfg.get("page")
        self.parent = parent or cfg.get("parent")
        self.timeout = timeout
        self.url = None  # the published page URL, for callers/tests

    @staticmethod
    def _esc(s):
        return (str(s).replace("&", "&amp;").replace("<", "&lt;")
                .replace(">", "&gt;"))

    def storage_xhtml(self, payload):
        """Confluence storage-format body."""
        e = self._esc
        rows = "".join("<tr><td>%s</td><td>%s</td></tr>" % (e(k), e(v))
                       for k, v in _metrics_rows(payload["metrics"]))
        units = "".join(
            "<tr><td>%s</td><td>%s</td><td>%d</td><td>%.4f</td></tr>"
            % (e(u["name"]), e(u["class"]), u["runs"], u["seconds"])
            for u in payload["units"])
        return (
            "<p>workflow <code>%s</code> (%s) — generated %s — checksum "
            "<code>%s</code></p>"
            "<h2>Metrics</h2><table><tbody>"
            "<tr><th>metric</th><th>value</th></tr>%s</tbody></table>"
            "<h2>Unit timings</h2><table><tbody>"
            "<tr><th>unit</th><th>class</th><th>runs</th>"
            "<th>seconds</th></tr>%s</tbody></table>"
            % (e(payload["workflow"]), e(payload["workflow_class"]),
               e(payload["generated"]), e(payload["checksum"][:16]),
               rows, units))

    def render(self, payload, out_dir):
        import base64
        import json as _json
        import urllib.request
        body = self.storage_xhtml(payload)
        path = os.path.join(out_dir,
                            _slug(payload["workflow"]) + "_report.xhtml")
        with open(path, "w") as f:
            f.write(body)
        if not self.server or not self.space:
            return path  # offline render only
        doc = {
            "type": "page",
            "title": self.page or payload["title"],
            "space": {"key": self.space},
            "body": {"storage": {"value": body,
                                 "representation": "storage"}},
        }
        if self.parent:
            doc["ancestors"] = [{"id": self.parent}]
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = "Bearer %s" % self.token
        elif self.username:
            cred = "%s:%s" % (self.username, self.password or "")
            headers["Authorization"] = "Basic %s" % base64.b64encode(
                cred.encode()).decode()
        req = urllib.request.Request(
            self.server.rstrip("/") + "/rest/api/content",
            data=_json.dumps(doc).encode(), headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                reply = _json.load(r)
        except Exception as e:
            # the offline .xhtml artifact above is the fallback — an
            # unreachable/refusing server must not crash the workflow's
            # end-of-train publishing step
            import logging
            logging.getLogger("ConfluenceBackend").warning(
                "publish to %s failed (%s) — offline report kept at %s",
                self.server, e, path)
            return path
        base = reply.get("_links", {}).get("base", self.server)
        webui = reply.get("_links", {}).get("webui", "")
        self.url = base + webui
        return path


BACKENDS = {b.NAME: b for b in (MarkdownBackend, HTMLBackend,
                                NotebookBackend, LaTeXBackend,
                                ConfluenceBackend)}
