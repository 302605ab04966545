"""Training dashboard HTTP server (reference VertxUIServer + TrainModule).

Reference: `deeplearning4j-vertx/.../VertxUIServer.java:78` serving the
train module (`module/train/TrainModule.java`) over HTTP, plus the remote
POST endpoints used by RemoteUIStatsStorageRouter. Counterpart of
``deeplearning4j_tpu/ui/server.py``: the same page, endpoints and JSON.

stdlib http.server via the shared handler base in `common/httpserver.py`
(Content-Length on every response, client disconnects without stack
traces — same hygiene as the serving front end); endpoints:
  GET  /                      dashboard (score chart, param norms, ratios)
  GET  /train/sessions        session id list
  GET  /train/overview?sid=   static info + updates
  GET  /metrics               runtime telemetry, Prometheus text exposition
  GET  /metrics.json          same registry as a JSON snapshot (+quantiles)
  GET  /debug/trace/<id>      one trace's buffered span events + tree
  GET  /debug/compile_cache   the kernel-library artifact store's inventory
  GET  /debug/memory          per-device memory stats (torch.cuda)
  POST /debug/profile?seconds=  on-demand torch.profiler capture
  POST /remote/static|update  remote stats ingestion

(The ``/debug/*`` family is the shared one from ``common/httpserver.py``
— the training dashboard answers the same debugging questions as the
serving front end, minus the serving-only recent-requests ring.)
"""
from __future__ import annotations

import json
import threading
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..common.environment import environment
from ..common.httpserver import (JsonRequestHandler,
                                 QuietThreadingHTTPServer, handle_debug_get,
                                 handle_debug_post, metrics_payload)
from .stats import BaseStatsStorage, InMemoryStatsStorage

_PAGE = """<!DOCTYPE html>
<html><head><title>DL4J-TPU Training UI</title>
<style>
 body { font-family: sans-serif; margin: 20px; background: #fafafa; }
 h1 { font-size: 20px; } h2 { font-size: 14px; color: #444; margin: 4px 0; }
 .row { display: flex; gap: 22px; flex-wrap: wrap; }
 canvas { background: #fff; border: 1px solid #ccc; }
 #meta { color: #666; font-size: 13px; margin-bottom: 10px; }
 select { font-size: 13px; margin: 0 8px 8px 0; }
 table { border-collapse: collapse; font-size: 12px; background: #fff; }
 th, td { border: 1px solid #ddd; padding: 3px 8px; text-align: left; }
 th { background: #eee; }
 .legend { font-size: 11px; }
 .legend span { margin-right: 10px; }
</style></head>
<body>
<h1>Training Dashboard</h1>
<div>
 session <select id="sess"></select>
 layer <select id="layersel"></select>
 param <select id="paramsel"></select>
</div>
<div id="meta"></div>
<div class="row">
 <div><h2>Score vs Iteration</h2><canvas id="score" width="440" height="240"></canvas></div>
 <div><h2>Update : Param Ratio (log10)</h2><canvas id="ratio" width="440" height="240"></canvas></div>
 <div><h2>Iteration Time (s)</h2><canvas id="itertime" width="440" height="240"></canvas></div>
 <div><h2>Device Memory (MB)</h2><canvas id="mem" width="440" height="240"></canvas></div>
</div>
<div class="row">
 <div><h2>Per-layer Mean |W| (log10)</h2>
  <canvas id="layers" width="440" height="240"></canvas>
  <div id="layerlegend" class="legend"></div></div>
 <div><h2>Parameter Histogram (latest)</h2>
  <canvas id="hist" width="440" height="240"></canvas></div>
 <div><h2>Layers</h2><table id="layertable"></table></div>
</div>
<script>
const PALETTE = ['#c33','#36c','#2a2','#b70','#829','#067','#a14','#551'];
function axes(c, canvas, xmin, xmax, ymin, ymax) {
  c.clearRect(0, 0, canvas.width, canvas.height);
  c.strokeStyle = '#999'; c.strokeRect(40, 15, canvas.width - 50, canvas.height - 40);
  c.fillStyle = '#333'; c.font = '11px sans-serif';
  c.fillText(ymax.toPrecision(4), 2, 20);
  c.fillText(ymin.toPrecision(4), 2, canvas.height - 25);
  c.fillText(String(xmin), 40, canvas.height - 8);
  c.fillText(String(xmax), canvas.width - 40, canvas.height - 8);
}
function drawSeries(canvas, xs, seriesList) {
  // seriesList: [{ys, color}] sharing the xs domain
  const c = canvas.getContext('2d');
  const all = seriesList.flatMap(s => s.ys).filter(y => isFinite(y));
  if (xs.length < 2 || !all.length) {
    c.clearRect(0, 0, canvas.width, canvas.height); return;
  }
  const xmin = Math.min(...xs), xmax = Math.max(...xs);
  const ymin = Math.min(...all), ymax = Math.max(...all);
  axes(c, canvas, xmin, xmax, ymin, ymax);
  const px = x => 40 + (x - xmin) / (xmax - xmin || 1) * (canvas.width - 50);
  const py = y => canvas.height - 25 - (y - ymin) / (ymax - ymin || 1) * (canvas.height - 40);
  for (const s of seriesList) {
    c.strokeStyle = s.color; c.beginPath();
    let started = false;
    xs.forEach((x, i) => {
      const y = s.ys[i];
      if (!isFinite(y)) return;
      if (started) c.lineTo(px(x), py(y)); else { c.moveTo(px(x), py(y)); started = true; }
    });
    c.stroke();
  }
}
function esc(t) {
  return String(t).replace(/[&<>"']/g,
      ch => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[ch]));
}
function drawLine(canvas, xs, ys, color) { drawSeries(canvas, xs, [{ys, color}]); }
function drawHist(canvas, hist) {
  const c = canvas.getContext('2d');
  c.clearRect(0, 0, canvas.width, canvas.height);
  if (!hist || !hist.counts || !hist.counts.length) return;
  const n = hist.counts.length, cmax = Math.max(...hist.counts);
  const e = hist.edges || [];
  axes(c, canvas, e.length ? e[0] : 0, e.length ? e[e.length - 1] : 1,
       0, cmax);
  const w = (canvas.width - 50) / n;
  c.fillStyle = '#36c';
  hist.counts.forEach((v, i) => {
    const h = v / (cmax || 1) * (canvas.height - 40);
    c.fillRect(40 + i * w, canvas.height - 25 - h, Math.max(w - 1, 1), h);
  });
}
function fillSelect(el, options) {
  // rebuild only when the option list changed (a rebuild collapses an
  // open dropdown); keep the user's selection, default to the LAST
  // option (newest session) on first fill
  const cur = el.value;
  const existing = [...el.options].map(o => o.value);
  if (existing.length !== options.length ||
      existing.some((v, i) => v !== options[i])) {
    el.innerHTML = '';
    for (const o of options) {
      const opt = document.createElement('option');
      opt.value = o; opt.textContent = o; el.appendChild(opt);
    }
    el.value = options.includes(cur) ? cur : options[options.length - 1];
  }
}
async function refresh() {
  const sessions = await (await fetch('train/sessions')).json();
  if (!sessions.length) return;
  fillSelect(document.getElementById('sess'), sessions);
  const sid = document.getElementById('sess').value;
  const data = await (await fetch('train/overview?sid=' + sid)).json();
  const ups = data.updates || [];
  const iters = ups.map(u => u.iteration);
  drawLine(document.getElementById('score'), iters, ups.map(u => u.score), '#c33');
  const rat = ups.filter(u => u.update_param_ratio != null);
  drawSeries(document.getElementById('ratio'), rat.map(u => u.iteration),
      [{ys: rat.map(u => Math.log10(u.update_param_ratio + 1e-12)), color: '#36c'}]);
  const tm = ups.filter(u => u.iter_seconds != null);
  drawSeries(document.getElementById('itertime'), tm.map(u => u.iteration),
      [{ys: tm.map(u => u.iter_seconds), color: '#2a2'}]);
  const mm = ups.filter(u => u.memory);
  drawSeries(document.getElementById('mem'), mm.map(u => u.iteration),
      [{ys: mm.map(u => u.memory.bytes_in_use / 1048576), color: '#b70'},
       {ys: mm.map(u => (u.memory.peak_bytes_in_use || 0) / 1048576), color: '#829'}]);

  // per-layer series: prefer the weight-like param (W/kernel) of each
  // layer over biases; note truncation when layers exceed the palette
  const last = ups[ups.length - 1] || {};
  const names = Object.keys(last.params || {});
  const layers = [...new Set(names.map(n => n.split('/')[0]))];
  const series = [], legend = [];
  layers.slice(0, PALETTE.length).forEach((ln, i) => {
    const mine = names.filter(n => n.startsWith(ln + '/'));
    const key = mine.find(n => /[/](W|w|kernel|Wx)$/.test(n)) || mine[0];
    if (!key) return;
    series.push({ys: ups.map(u => {
      const p = (u.params || {})[key];
      return p ? Math.log10(p.mean_mag + 1e-12) : NaN;
    }), color: PALETTE[i]});
    legend.push(`<span style="color:${PALETTE[i]}">■ ${esc(key)}</span>`);
  });
  if (layers.length > PALETTE.length) {
    legend.push(`<span>(+${layers.length - PALETTE.length} more layers)</span>`);
  }
  drawSeries(document.getElementById('layers'), iters, series);
  document.getElementById('layerlegend').innerHTML = legend.join('');

  // histogram of the selected param (latest update that carries one);
  // cleared when none exists so a stale chart never lingers
  fillSelect(document.getElementById('layersel'), layers);
  const lsel = document.getElementById('layersel').value;
  const pnames = names.filter(n => n.startsWith((lsel || '') + '/'));
  fillSelect(document.getElementById('paramsel'), pnames);
  const psel = document.getElementById('paramsel').value;
  let hist = null;
  for (let i = ups.length - 1; i >= 0; i--) {
    const p = (ups[i].params || {})[psel];
    if (p && p.histogram) { hist = p.histogram; break; }
  }
  drawHist(document.getElementById('hist'), hist);

  // layer table: latest l2 / mean|W| per param (names escaped — the
  // remote ingestion endpoint is open, so treat them as untrusted)
  const rows = ['<tr><th>param</th><th>L2</th><th>mean |W|</th></tr>'];
  for (const n of names) {
    const p = last.params[n];
    rows.push(`<tr><td>${esc(n)}</td><td>${p.l2.toPrecision(5)}</td>` +
              `<td>${p.mean_mag.toPrecision(5)}</td></tr>`);
  }
  document.getElementById('layertable').innerHTML = rows.join('');

  const s = data.static || {};
  document.getElementById('meta').textContent =
    `session ${sid} | ${s.model_class || ''} | layers: ${s.n_layers || '?'} ` +
    `| params: ${s.n_params || '?'} | backend: ${s.backend || '?'} ` +
    `x${s.device_count || 1} | updates: ${ups.length}`;
}
refresh(); setInterval(refresh, 2000);
</script></body></html>"""


class UIServer:
    """Reference UIServer.getInstance().attach(statsStorage) pattern."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000):
        self.port = port
        self.storage: BaseStatsStorage = InMemoryStatsStorage()
        self._httpd = None
        self._thread = None

    @classmethod
    def get_instance(cls, port: int = 9000) -> "UIServer":
        if cls._instance is None:
            cls._instance = UIServer(port)
        return cls._instance

    def attach(self, storage: BaseStatsStorage):
        self.storage = storage
        return self

    # -- http -------------------------------------------------------------
    def _handler(self):
        server = self

        class Handler(JsonRequestHandler):
            def do_GET(self):
                url = urlparse(self.path)
                if url.path in ("/", "/train", "/train/"):
                    self.send_payload(_PAGE.encode(), "text/html")
                elif url.path == "/metrics":
                    # Prometheus text exposition of the process registry
                    # (training + serving instrumentation alike)
                    self.send_payload(*metrics_payload())
                elif url.path == "/metrics.json":
                    self.send_payload(*metrics_payload("json"))
                elif url.path == "/train/sessions":
                    self.send_json(server.storage.list_session_ids())
                elif url.path == "/train/overview":
                    q = parse_qs(url.query)
                    sid = q.get("sid", [""])[0]
                    if not sid:
                        ids = server.storage.list_session_ids()
                        sid = ids[-1] if ids else ""
                    self.send_json({
                        "static": server.storage.get_static_info(sid),
                        "updates": server.storage.get_updates(sid),
                    })
                elif url.path.startswith("/debug/"):
                    if not (environment().debug_endpoints_enabled()
                            and handle_debug_get(self, url.path)):
                        self.send_json({"error": "not found"}, 404)
                else:
                    self.send_json({"error": "not found"}, 404)

            def do_POST(self):
                url = urlparse(self.path)
                if url.path.startswith("/debug/"):
                    if not (environment().debug_endpoints_enabled()
                            and handle_debug_post(self, url.path,
                                                  parse_qs(url.query))):
                        self.send_json({"error": "not found"}, 404)
                    return
                payload = json.loads(self.read_body() or b"{}")
                if self.path == "/remote/static":
                    server.storage.put_static_info(payload["session"],
                                                   payload["data"])
                    self.send_json({"ok": True})
                elif self.path == "/remote/update":
                    server.storage.put_update(payload["session"],
                                              payload["data"])
                    self.send_json({"ok": True})
                else:
                    self.send_json({"error": "not found"}, 404)

        return Handler

    def start(self) -> int:
        """Start serving (daemon thread); returns the bound port."""
        self._httpd = QuietThreadingHTTPServer(("127.0.0.1", self.port),
                                               self._handler())
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
