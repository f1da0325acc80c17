"""Frontend — the web command composer (the port of
``veles_tpu/frontend.py``): ``--frontend`` serves a browser form listing
every argument of the command line; a submitted form composes an argv
(:func:`compose_argv`) and the waiting process runs it."""

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from veles_tpu_torch.logger import Logger

_PAGE = """<!DOCTYPE html>
<html><head><title>veles_tpu_torch frontend</title><style>
 body { font-family: sans-serif; margin: 2em; max-width: 48em; }
 label { display: block; margin-top: .6em; font-weight: bold; }
 .help { color: #666; font-weight: normal; font-size: .9em; }
 input[type=text] { width: 100%; }
 button { margin-top: 1em; padding: .5em 2em; }
</style></head><body>
<h2>Compose a veles_tpu_torch run</h2>
<form method="post" action="/compose">%FIELDS%
<button type="submit">Run</button></form></body></html>
"""


def _fields_from_parser(parser):
    rows = []
    for action in parser._actions:
        if action.dest in ("help",):
            continue
        name = (action.option_strings[-1] if action.option_strings
                else action.dest)
        help_text = (action.help or "").replace("<", "&lt;")
        if action.const is True or getattr(action, "nargs", None) == 0 \
                or type(action).__name__ == "_StoreTrueAction":
            field = ('<label>%s <span class="help">%s</span></label>'
                     '<input type="checkbox" name="%s" value="1">'
                     % (name, help_text, action.dest))
        else:
            field = ('<label>%s <span class="help">%s</span></label>'
                     '<input type="text" name="%s">'
                     % (name, help_text, action.dest))
        rows.append(field)
    return "\n".join(rows)


def compose_argv(parser, form):
    """Browser form dict → argv list (positional workflow/config first,
    then flags)."""
    argv = []
    by_dest = {a.dest: a for a in parser._actions}
    workflow = form.get("workflow", "").strip()
    config = form.get("config", "").strip()
    if workflow:
        argv.append(workflow)
        if config:  # config is positional #2 — meaningless alone
            argv.append(config)
    elif config:
        raise ValueError("a config file needs a workflow file")
    for dest, value in form.items():
        action = by_dest.get(dest)
        if action is None or not action.option_strings \
                or dest in ("workflow", "config",
                            "frontend", "frontend_port"):
            # composing another frontend would recurse into a second
            # bind of the same port
            continue
        value = value.strip()
        if not value:
            continue
        opt = action.option_strings[-1]
        if type(action).__name__ in ("_StoreTrueAction", "_CountAction"):
            argv.append(opt)
        elif type(action).__name__ == "_AppendAction":
            for part in value.split(";;"):
                if part.strip():
                    argv += [opt, part.strip()]
        else:
            argv += [opt, value]
    return argv


class Frontend(Logger):
    """Serves the composer page; :meth:`wait` blocks until a command is
    submitted and returns the composed argv."""

    def __init__(self, parser, port=0, host="127.0.0.1"):
        super(Frontend, self).__init__()
        self.parser = parser
        self._result = None
        self._done = threading.Event()
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                body = _PAGE.replace(
                    "%FIELDS%",
                    _fields_from_parser(frontend.parser)).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length).decode()
                form = dict(urllib.parse.parse_qsl(raw))
                try:
                    argv = compose_argv(frontend.parser, form)
                except ValueError as e:
                    self.send_error(400, str(e))
                    return
                blob = json.dumps({"argv": argv}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)
                frontend._result = argv
                frontend._done.set()

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="frontend")
        self._thread.start()
        self.info("frontend on http://%s:%d/ — compose and submit",
                  host, self.port)

    def wait(self, timeout=None):
        if not self._done.wait(timeout):
            return None
        return self._result

    def stop(self):
        self._server.shutdown()
        self._server.server_close()  # release the port for the run
