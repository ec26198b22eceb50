"""Interactive web viewer: render-from-pose over HTTP.

Counterpart of `omnigs_tpu/viewer/server.py`: a stdlib threading server
and a vanilla-JS page with WASD/drag SE(3) navigation, color/depth
display modes, a live scale-modifier control, the undistort mask applied
to every frame, and, when attached to a live trainer, the editor of the
trainer's variable parameters over ``/params``. Frames ship as JPEG
(quality 90, through PIL).

``render_fn(viewmatrix, campos, mode, scale)`` returns an (H, W, 3) tensor,
on the card or the CPU. It runs on the request thread under the state's
lock, and the frame comes back to the host under the same lock, once per
request; a live viewer passes the trainer's lock (`viewer/live.py`).
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from omnigs_torch.train.renderer import render_model

_PAGE = """<!DOCTYPE html>
<html><head><title>omnigs_torch viewer</title><style>
body{margin:0;background:#111;color:#eee;font-family:monospace}
#hud{position:fixed;top:8px;left:8px;background:#0008;padding:8px}
img{display:block;margin:auto;image-rendering:pixelated}
</style></head><body>
<div id="hud">WASD+QE move &middot; drag look &middot; [m] mode &middot; fps <span id="fps">-</span><br>
scale <input type="range" id="scale" min="0.05" max="2.0" step="0.05" value="1.0" style="width:120px">
<span id="scaleval">1.00</span><div id="params"></div></div>
<img id="view" width="%WIDTH%" height="%HEIGHT%">
<script>
let yaw=0, pitch=0, pos=[0,0,0], mode="color", busy=false, last=performance.now();
let scale=1.0;
const sl=document.getElementById("scale"), sv=document.getElementById("scaleval");
sl.oninput=()=>{scale=parseFloat(sl.value); sv.textContent=scale.toFixed(2)};
// live training parameters (VariableParameters analog): populated when the
// server is attached to a trainer
fetch('/params').then(r=>r.json()).then(p=>{
  const div=document.getElementById("params");
  for(const k in p){
    const row=document.createElement("div");
    row.innerHTML=`${k} <input size=9 id="p_${k}" value="${p[k]}">`;
    div.appendChild(row);
    row.querySelector("input").onchange=e=>{
      fetch('/params',{method:'POST',body:JSON.stringify({[k]:parseFloat(e.target.value)})});
    };
  }
}).catch(()=>{});
const img=document.getElementById("view"), fps=document.getElementById("fps");
const keys={};
onkeydown=e=>{keys[e.key.toLowerCase()]=1; if(e.key=='m') mode=(mode=="color")?"depth":"color";};
onkeyup=e=>{keys[e.key.toLowerCase()]=0};
let drag=null;
img.onmousedown=e=>{drag=[e.clientX,e.clientY]};
onmouseup=()=>{drag=null};
onmousemove=e=>{if(drag){yaw+=(e.clientX-drag[0])*0.005; pitch+=(e.clientY-drag[1])*0.005; drag=[e.clientX,e.clientY];}};
function step(){
  const v=0.1, cy=Math.cos(yaw), sy=Math.sin(yaw);
  if(keys['w']){pos[0]+=sy*v; pos[2]+=cy*v}
  if(keys['s']){pos[0]-=sy*v; pos[2]-=cy*v}
  if(keys['a']){pos[0]-=cy*v; pos[2]+=sy*v}
  if(keys['d']){pos[0]+=cy*v; pos[2]-=sy*v}
  if(keys['q']){pos[1]-=v} if(keys['e']){pos[1]+=v}
}
async function loop(){
  step();
  if(!busy){
    busy=true;
    try{
      const r=await fetch('/render',{method:'POST',body:JSON.stringify({yaw,pitch,pos,mode,scale})});
      const b=await r.blob();
      img.src=URL.createObjectURL(b);
      const now=performance.now(); fps.textContent=(1000/(now-last)).toFixed(1); last=now;
    }finally{busy=false}
  }
  requestAnimationFrame(loop);
}
loop();
</script></body></html>"""


class ViewerState:
    """The render-from-pose bridge: ``render_fn`` runs under ``lock`` (a new
    one unless given), so a live trainer can share its model."""

    def __init__(self, render_fn, width: int, height: int, mask=None,
                 params_get=None, params_set=None, lock=None):
        self.render_fn = render_fn
        self.width = width
        self.height = height
        # undistort mask, multiplied onto every served frame
        self.mask = None if mask is None else np.asarray(mask)
        # live tuning: () -> dict / (dict) -> None (the trainer's
        # get/set_variable_parameters)
        self.params_get = params_get
        self.params_set = params_set
        self.lock = threading.Lock() if lock is None else lock


def _pose_to_viewmatrix(yaw: float, pitch: float, pos):
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    Ry = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]], np.float32)
    Rx = np.array([[1, 0, 0], [0, cp, sp], [0, -sp, cp]], np.float32)
    R_wc = Ry @ Rx
    R_cw = R_wc.T
    t_cw = -R_cw @ np.asarray(pos, np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3] = R_cw
    vm[:3, 3] = t_cw
    return vm, np.asarray(pos, np.float32)


def render_view(model, camera, vm, campos, bg, sh_degree, config, mode, scale):
    """One served view of ``model`` → (H, W, 3) tensor on its device: the
    color, or (``mode == "depth"``) the depth normalised by its max. Runs
    on the model's card whatever the calling thread's current device."""
    dev = model.xyz.device
    on_card = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
    with on_card, torch.inference_mode():
        res = render_model(
            model, camera, torch.as_tensor(vm, device=dev),
            torch.as_tensor(campos, device=dev), bg, sh_degree, config,
            render_depth=(mode == "depth"), scale_modifier=scale,
        )
        if mode == "depth":
            d = res.image[0]
            return (d / (torch.max(d) + 1e-6))[..., None].expand(-1, -1, 3)
        return res.image.permute(1, 2, 0)


def render_frame(state: ViewerState, req: dict) -> np.ndarray:
    """One request's (H, W, 3) float32 frame on the host, masked."""
    vm, campos = _pose_to_viewmatrix(
        req.get("yaw", 0.0), req.get("pitch", 0.0), req.get("pos", [0, 0, 0])
    )
    with state.lock:
        img = state.render_fn(
            vm, campos, req.get("mode", "color"), float(req.get("scale", 1.0))
        )
        img = img.detach().cpu().numpy()
    if state.mask is not None:
        img = img * state.mask[..., None]
    return img


def encode_jpeg(img: np.ndarray) -> bytes:
    from PIL import Image

    arr = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/params":
                self._send_json(
                    {} if state.params_get is None else state.params_get()
                )
                return
            page = _PAGE.replace("%WIDTH%", str(state.width)).replace(
                "%HEIGHT%", str(state.height)
            )
            self._send(page.encode(), "text/html")

        def _send(self, body: bytes, content_type: str):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, obj):
            self._send(json.dumps(obj).encode(), "application/json")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or "{}")
            if self.path == "/params":
                if state.params_set is not None:
                    with state.lock:
                        state.params_set(req)
                self._send_json({"ok": True})
                return
            self._send(encode_jpeg(render_frame(state, req)), "image/jpeg")

    return Handler


def make_server(state: ViewerState, port: int, host: str = "0.0.0.0"):
    """The threading HTTP server of ``state`` (not started; port 0 picks a
    free one, ``server_address[1]`` says which; ``viewer_state`` is
    ``state``)."""
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    httpd.viewer_state = state
    return httpd


def serve(render_fn, width: int, height: int, port: int = 8000,
          mask=None, params_get=None, params_set=None, lock=None,
          host: str = "0.0.0.0"):
    """Blocking viewer server. `render_fn(viewmatrix, campos, mode, scale)`.
    Pass a trainer's get/set_variable_parameters as params_get/params_set
    (and its lock) to tune the running training from the page."""
    state = ViewerState(render_fn, width, height, mask, params_get, params_set, lock)
    httpd = make_server(state, port, host)
    print(f"viewer listening on http://{host}:{httpd.server_address[1]}", flush=True)
    httpd.serve_forever()
