"""Interactive progressive viewer — the igview analog (port of
ignis_tpu/view.py).

The reference ships an SDL2+ImGui viewer whose main loop handles camera
input, resets the film on movement, steps the runtime progressively, and
tonemaps for display with optional auto-exposure and AOV selection
(/root/reference/src/frontend/view/main.cpp:143-185,
src/frontend/view/Context.cpp:532-570). This environment is headless, so
the UI is a local web page: a stdlib HTTP server streams tonemapped PNG
frames to the browser and receives camera/tonemap/parameter events; the
render loop semantics (reset on move, incFrameCount per frame, progressive
accumulation between moves) match the reference loop.

Usage:  python -m ignis_tpu_torch.view scene.json [--port 8474] [--spi N]
        [--term]   # ANSI half-block preview in the terminal instead
        [--target cpu]   # the CUDA card unless asked (exit 2 without one)

Frames are PNGs of utils/image.encode_png (no PIL). The render loop runs
in a worker thread, which first makes the runtime's CUDA device its
current device, so the kernels launch on that device's current stream.

Controls (browser): drag = orbit, shift-drag = pan, wheel = zoom,
WASDQE keys = fly, t = cycle tonemap operator, +/- exposure, 0 =
auto-exposure toggle, a = cycle AOV layer; scene parameters from
parameterDescs get sliders (reference Loader.cpp:24-82 UI metadata).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .cli import add_target_args, target_device
from .utils.image import encode_png

TONEMAPS = ["none", "reinhard", "mod_reinhard", "aces", "uncharted2",
            "agx", "pbrneutral"]


class CameraRig:
    """Orbit/fly camera producing (eye, dir, up) for setCameraOrientation."""

    def __init__(self, eye, direction, up, scene_radius=1.0):
        self.eye = np.asarray(eye, np.float64)
        d = np.asarray(direction, np.float64)
        self.dir = d / max(np.linalg.norm(d), 1e-12)
        u = np.asarray(up, np.float64)
        self.up = u / max(np.linalg.norm(u), 1e-12)
        self.speed = max(float(scene_radius), 1e-3) * 0.1

    def pose(self):
        return (tuple(self.eye), tuple(self.dir), tuple(self.up))

    def _right(self):
        r = np.cross(self.dir, self.up)
        return r / max(np.linalg.norm(r), 1e-12)

    def orbit(self, dx, dy):
        """Rotate the view direction around the eye (FPS-style look)."""
        yaw = -dx * 0.005
        pitch = -dy * 0.005
        r = self._right()
        d = self.dir
        # yaw around up, pitch around right
        d = d * math.cos(yaw) + np.cross(self.up, d) * math.sin(yaw)
        d = d / max(np.linalg.norm(d), 1e-12)
        r = np.cross(d, self.up)
        r /= max(np.linalg.norm(r), 1e-12)
        d2 = d * math.cos(pitch) + np.cross(r, d) * math.sin(pitch)
        # avoid gimbal flip at the poles
        if abs(float(np.dot(d2, self.up))) < 0.999:
            d = d2
        self.dir = d / max(np.linalg.norm(d), 1e-12)

    def pan(self, dx, dy):
        r = self._right()
        v = np.cross(r, self.dir)
        self.eye += (-dx * r + dy * v) * self.speed * 0.02

    def dolly(self, steps):
        self.eye += self.dir * (steps * self.speed)

    def fly(self, key):
        r = self._right()
        moves = {"w": self.dir, "s": -self.dir, "a": -r, "d": r,
                 "q": -self.up, "e": self.up}
        if key in moves:
            self.eye += moves[key] * self.speed


class ViewerState:
    def __init__(self, rt):
        self.rt = rt
        cam = rt.scene.camera
        g = lambda v: (float(v.x), float(v.y), float(v.z))
        self.rig = CameraRig(g(cam.eye), g(cam.dir), g(cam.up),
                             float(rt.scene.scene_radius))
        self.lock = threading.Lock()       # protects the fields below
        self.dirty = False                 # camera/scene changed -> reset
        self.running = True
        self.tonemap_method = 3            # ACES, reference default UI
        self.exposure = 0.0
        self.auto_exposure = False
        self.aov = ""                      # "" = Color
        self.frame_png = b""
        self.frame_seq = 0
        self.frame_event = threading.Condition()
        self.stats = {}
        self.events = []                   # queued input events

    # -- render thread -----------------------------------------------------
    def render_loop(self):
        """Step, publish and handle events until `running` is cleared."""
        rt = self.rt
        if rt.device.type == "cuda":
            import torch
            torch.cuda.set_device(rt.device)
        while self.running:
            # drain input events (main.cpp:148 handleInput)
            with self.lock:
                events, self.events = self.events, []
            moved = False
            for ev in events:
                moved |= self._apply_event(ev)
            if moved:
                rt.setCameraOrientation(*self.rig.pose())
                rt.reset()                 # main.cpp: reset film on move
            t0 = time.time()
            rt.step()
            dt = max(time.time() - t0, 1e-9)
            rt.incFrameCount()
            self._publish(dt)

    def _apply_event(self, ev) -> bool:
        k = ev.get("type")
        if k == "orbit":
            self.rig.orbit(ev.get("dx", 0), ev.get("dy", 0))
        elif k == "pan":
            self.rig.pan(ev.get("dx", 0), ev.get("dy", 0))
        elif k == "zoom":
            self.rig.dolly(ev.get("steps", 0))
        elif k == "key":
            key = ev.get("key", "")
            if key in "wasdqe":
                self.rig.fly(key)
            elif key == "t":
                self.tonemap_method = (self.tonemap_method + 1) \
                    % len(TONEMAPS)
                return False
            elif key in ("+", "="):
                self.exposure += 0.5
                return False
            elif key == "-":
                self.exposure -= 0.5
                return False
            elif key == "0":
                self.auto_exposure = not self.auto_exposure
                return False
            elif key == "v":
                aovs = [""] + self.rt.AOVs
                self.aov = aovs[(aovs.index(self.aov) + 1) % len(aovs)]
                return False
            else:
                return False
        elif k == "param":
            self.rt.setParameter(ev["name"], ev["value"])
            return True
        elif k == "tonemap":
            self.tonemap_method = int(ev.get("method",
                                             self.tonemap_method))
            self.exposure = float(ev.get("exposure", self.exposure))
            return False
        else:
            return False
        return True

    def _publish(self, dt):
        rt = self.rt
        if self.aov:
            img = np.asarray(rt.getFramebufferForHost(self.aov))
            img = np.clip(np.abs(img) / max(float(np.abs(img).max()),
                                            1e-9), 0, 1)
            ldr = (img * 255).astype(np.uint8)
        else:
            exposure = self.exposure
            if self.auto_exposure:
                # Context.cpp:532-570 auto exposure from imageinfo stats
                fb = rt.framebuffer(normalized=True).cpu().numpy()
                lum = fb @ np.array([0.2126, 0.7152, 0.0722])
                mx = float(np.quantile(lum, 0.98))
                exposure = -math.log2(max(mx, 1e-6))
            ldr = rt.tonemap(method=self.tonemap_method, exposure=exposure)
        png = encode_png(ldr)
        spp = rt.sample_count
        n = rt.framebuffer_width * rt.framebuffer_height * rt.SPI
        with self.frame_event:
            self.frame_png = png
            self.frame_seq += 1
            self.stats = {
                "iteration": rt.iteration_count, "spp": spp,
                "frame": rt.FrameCount,
                "msamples_per_s": round(n / dt / 1e6, 3),
                "tonemap": TONEMAPS[self.tonemap_method],
                "exposure": round(self.exposure, 2),
                "auto_exposure": self.auto_exposure,
                "aov": self.aov or "Color",
                "aovs": [""] + self.rt.AOVs,
                "params": self.rt.parameterDescs(),
            }
            self.frame_event.notify_all()

    def wait_frame(self, have_seq, timeout=30.0):
        with self.frame_event:
            self.frame_event.wait_for(
                lambda: self.frame_seq != have_seq or not self.running,
                timeout=timeout)
            return self.frame_png, self.frame_seq, dict(self.stats)


PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>igtorch-view</title><style>
body{margin:0;background:#111;color:#ccc;font:13px system-ui;display:flex}
#img{image-rendering:pixelated;cursor:grab;flex:0 0 auto}
#side{padding:10px;min-width:220px}
.row{margin:4px 0} input[type=range]{width:140px;vertical-align:middle}
#stats{white-space:pre;font-family:monospace;color:#8c8}
button{margin:1px}
</style></head><body>
<img id="img"><div id="side">
<div id="stats">connecting…</div>
<div class="row">tonemap <select id="tm"></select></div>
<div class="row">exposure <input id="exp" type="range" min="-8" max="8"
 step="0.25" value="0"><span id="expv">0</span></div>
<div class="row">AOV <select id="aov"></select></div>
<div id="params"></div>
<div class="row" style="color:#777">drag orbit · shift-drag pan · wheel
 zoom · wasdqe fly · t/v/+/-/0 keys</div>
</div>
<script>
const img=document.getElementById('img');let seq=0,drag=null;
const TM=%TM%;const tm=document.getElementById('tm');
TM.forEach((n,i)=>tm.add(new Option(n,i)));tm.value=3;
function post(o){fetch('/event',{method:'POST',body:JSON.stringify(o)})}
tm.onchange=_=>post({type:'tonemap',method:+tm.value,
 exposure:+document.getElementById('exp').value});
document.getElementById('exp').oninput=function(){
 document.getElementById('expv').textContent=this.value;
 post({type:'tonemap',method:+tm.value,exposure:+this.value})};
document.getElementById('aov').onchange=function(){post({type:'key',key:'v'})};
img.onmousedown=e=>{drag={x:e.clientX,y:e.clientY,pan:e.shiftKey}};
window.onmouseup=_=>drag=null;
window.onmousemove=e=>{if(!drag)return;
 post({type:drag.pan?'pan':'orbit',dx:e.clientX-drag.x,dy:e.clientY-drag.y});
 drag={x:e.clientX,y:e.clientY,pan:drag.pan}};
img.onwheel=e=>{e.preventDefault();post({type:'zoom',steps:e.deltaY<0?1:-1})};
window.onkeydown=e=>{if(!e.repeat)post({type:'key',key:e.key})};
let paramsBuilt=false;
function buildParams(ps){const box=document.getElementById('params');
 box.innerHTML='';for(const[name,d]of Object.entries(ps)){
 if(typeof d.value!=='number')continue;
 const div=document.createElement('div');div.className='row';
 div.innerHTML=name+' <input type="range" min="'+(d.min??0)+'" max="'+
 (d.max??1)+'" step="'+(d.step??0.01)+'" value="'+d.value+'">';
 div.querySelector('input').oninput=function(){
  post({type:'param',name:name,value:+this.value})};
 box.appendChild(div);}paramsBuilt=true}
async function loop(){for(;;){try{
 const r=await fetch('/frame?seq='+seq);seq=+r.headers.get('X-Seq');
 const st=JSON.parse(r.headers.get('X-Stats'));
 document.getElementById('stats').textContent=
  'iter '+st.iteration+'  spp '+st.spp+'\\n'+st.msamples_per_s+
  ' Msamples/s\\n'+st.tonemap+' exp '+st.exposure+(st.auto_exposure?' (auto)':'')+
  '\\nAOV '+st.aov;
 if(!paramsBuilt)buildParams(st.params||{});
 const b=await r.blob();img.src=URL.createObjectURL(b);
}catch(e){await new Promise(r=>setTimeout(r,500))}}}
loop();
</script></body></html>"""


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path.startswith("/frame"):
                have = 0
                if "seq=" in self.path:
                    try:
                        have = int(self.path.split("seq=")[1].split("&")[0])
                    except ValueError:
                        pass
                png, seq, stats = state.wait_frame(have)
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("X-Seq", str(seq))
                self.send_header("X-Stats", json.dumps(stats))
                self.send_header("Content-Length", str(len(png)))
                self.end_headers()
                self.wfile.write(png)
            elif self.path.startswith("/state"):
                _, _, stats = state.wait_frame(-1, timeout=0.01)
                body = json.dumps(stats).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                body = PAGE.replace("%TM%", json.dumps(TONEMAPS)).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                ev = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                ev = {}
            with state.lock:
                state.events.append(ev)
            self.send_response(204)
            self.end_headers()
    return Handler


def term_preview(rt, spp):
    """ANSI half-block terminal preview (headless fallback)."""
    for _ in range(max(1, spp // max(rt.SPI, 1))):
        rt.step()
    ldr = rt.tonemap(method=3)
    h, w = ldr.shape[:2]
    cols = min(96, w)
    rows = cols * h // w // 2 * 2
    ys = (np.arange(rows) * (h / rows)).astype(int)
    xs = (np.arange(cols) * (w / cols)).astype(int)
    small = ldr[ys][:, xs]
    out = []
    for y in range(0, rows - 1, 2):
        line = []
        for x in range(cols):
            t, b = small[y, x], small[y + 1, x]
            line.append(f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m"
                        f"\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀")
        out.append("".join(line) + "\x1b[0m")
    print("\n".join(out))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="igtorch-view", description=__doc__.split("\n")[0])
    ap.add_argument("scene")
    ap.add_argument("--port", type=int, default=8474)
    ap.add_argument("--spi", type=int, default=1)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--term", action="store_true",
                    help="one ANSI terminal preview instead of the server")
    ap.add_argument("--term-spp", type=int, default=8)
    add_target_args(ap)
    args = ap.parse_args(argv)
    device = target_device(args)
    if device is None:
        return 2

    from . import loadFromFile
    overrides = {"spi": args.spi}
    if args.width:
        overrides["width"] = args.width
    if args.height:
        overrides["height"] = args.height
    rt = loadFromFile(args.scene, device=device, **overrides)
    for wmsg in rt.warnings:
        print(f"[warn] {wmsg}", file=sys.stderr)

    if args.term:
        term_preview(rt, args.term_spp)
        return 0

    state = ViewerState(rt)
    server = ThreadingHTTPServer(("127.0.0.1", args.port),
                                 make_handler(state))
    th = threading.Thread(target=state.render_loop, daemon=True)
    th.start()
    print(f"igtorch-view: http://127.0.0.1:{args.port}/  "
          f"({rt.framebuffer_width}x{rt.framebuffer_height}, "
          f"spi {rt.SPI})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        state.running = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
