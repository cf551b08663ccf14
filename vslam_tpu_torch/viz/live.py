"""Live trajectory/odometry viewer — the RViz channel without ROS.

A copy of `vslam_tpu.viz.live` (the standard library and numpy only): the
same publisher, HTTP state bus and page. The port's producers publish from
host arrays they have already fetched (`SequentialOdometry` at each retired
chunk, `OdometryPipeline` per frame), so the viewer never reads the card.

Role parity: the reference's NodeMapping publishes, per frame, an
Odometry message (camera-in-world pose, its 6x6 covariance, and the twist),
a growing Path, and a TF transform; RViz subscribes and renders them live
(reference src/ros/nodes/NodeMapping.cpp:231-272 and
config/rviz/odom_eval.rviz). This module fills the same role with the
stdlib only:

- ``LiveViz`` is the publisher. ``publish_odometry`` / ``publish_keyframe``
  / ``publish_landmarks`` mirror the reference's /odom, keyframe markers
  and map-point cloud. Publishing is lock-guarded appends to an in-memory
  state — O(1) per frame, never on the device path, and safe to call from
  the pipelined retire thread.
- A background ``ThreadingHTTPServer`` exposes the state:
  ``GET /state.json`` is the message bus (poll it from any tool), and
  ``GET /`` serves a self-contained HTML page that polls state.json and
  renders an ORBITABLE 3-D SVG view (drag to orbit, wheel to zoom;
  default orientation is the top-down x/z view) of the trajectory,
  keyframes, map points, and the current pose's RGB axis triad from the
  published quaternion, with pose/covariance/fps readouts — the RViz
  odom_eval view (reference config/rviz/odom_eval.rviz:107,181-183), in
  a browser, with zero extra dependencies.

Conventions: publishers take WORLD->CAMERA poses (the pipeline's native
``Frame::pose`` convention) and the viewer displays camera-in-world, the
same inversion the reference applies at its publish boundary
(NodeMapping.cpp:238, ``pose().inverse()``).

The path ring decimates by 2 when it exceeds ``max_path`` points, so a
multi-hour run keeps a bounded, uniformly thinned trail (nav_msgs/Path in
the reference grows unboundedly; bounding it is deliberate).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..io.tum import matrix_to_quat
from ..utils.log import get_logger

_log = get_logger("viz")


def _cam_in_world(pose_w2c: np.ndarray) -> np.ndarray:
    """Invert a world->camera SE(3) matrix (R^T, -R^T t) without np.linalg."""
    T = np.asarray(pose_w2c, dtype=np.float64)
    out = np.eye(4)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return out


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>vslam_tpu live</title>
<style>
 body{background:#111;color:#ddd;font:13px monospace;margin:0;display:flex}
 #panel{padding:12px;min-width:260px}
 #panel h1{font-size:14px;margin:0 0 8px}
 #panel td{padding:1px 6px 1px 0}
 #hint{color:#777;margin-top:10px}
 svg{flex:1;height:100vh;background:#181818;cursor:grab}
 .path{fill:none;stroke:#4cc;stroke-width:1.5}
 .kf{fill:#fa0}.lm{fill:#555}.cur{fill:#f44}
 .ax{fill:none;stroke-width:2}
</style></head><body>
<div id="panel"><h1>vslam_tpu live</h1><table id="stats"></table>
<div id="hint">drag: orbit &middot; wheel: zoom<br>
3-D view (RViz odom_eval role): path, keyframes,<br>
map points, current pose axes (x red / y green / z blue)</div></div>
<svg id="view" viewBox="-1 -1 2 2" preserveAspectRatio="xMidYMid meet"></svg>
<script>
const fmt=(x,n=3)=>Number(x).toFixed(n);
// orbit state: default reproduces the old top-down x/z view
let yaw=0, pitch=Math.PI/2, zoom=1, drag=null, S=null;
const view=document.getElementById('view');
view.addEventListener('mousedown',e=>{drag=[e.clientX,e.clientY]});
window.addEventListener('mouseup',()=>{drag=null});
window.addEventListener('mousemove',e=>{
 if(!drag)return;
 yaw+=(e.clientX-drag[0])*0.01; pitch+=(e.clientY-drag[1])*0.01;
 pitch=Math.max(-Math.PI/2,Math.min(Math.PI/2,pitch));
 drag=[e.clientX,e.clientY]; if(S)draw(S);});
view.addEventListener('wheel',e=>{
 e.preventDefault(); zoom*=Math.exp(-e.deltaY*0.001); if(S)draw(S);},
 {passive:false});
function quat2R(q){ // [x,y,z,w] -> row-major 3x3
 const[x,y,z,w]=q;
 return[[1-2*(y*y+z*z),2*(x*y-z*w),2*(x*z+y*w)],
        [2*(x*y+z*w),1-2*(x*x+z*z),2*(y*z-x*w)],
        [2*(x*z-y*w),2*(y*z+x*w),1-2*(x*x+y*y)]];}
function draw(s){
 const path=s.path; if(!path.length) return;
 const n=path.length;
 const c=[0,1,2].map(k=>path.reduce((a,p)=>a+p[k],0)/n);
 let span=0.1;
 for(const p of path) span=Math.max(span,
   Math.abs(p[0]-c[0]),Math.abs(p[1]-c[1]),Math.abs(p[2]-c[2]));
 span=span*2.3/zoom;
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 // orbit camera: yaw about world y, then pitch; orthographic projection
 const proj=p=>{
  const x=p[0]-c[0], y=p[1]-c[1], z=p[2]-c[2];
  const x1=cy*x+sy*z, z1=-sy*x+cy*z;
  const y2=cp*y-sp*z1;
  return[x1/span*2, y2/span*2];};
 const P=path.map(proj);
 const pts=P.map(q=>`${q[0]},${q[1]}`).join(' ');
 const kfs=s.keyframes.map(p=>{const q=proj(p);
  return `<circle class="kf" cx="${q[0]}" cy="${q[1]}" r="0.016"/>`}).join('');
 const lms=s.landmarks.map(p=>{const q=proj(p);
  return `<circle class="lm" cx="${q[0]}" cy="${q[1]}" r="0.006"/>`}).join('');
 // current pose axes from the published quaternion (camera-in-world)
 const R=quat2R(s.quaternion), o=s.position, L=span*0.06;
 const axes=[0,1,2].map(k=>{
  const tip=[o[0]+R[0][k]*L, o[1]+R[1][k]*L, o[2]+R[2][k]*L];
  const a=proj(o), b=proj(tip), col=['#f44','#4f4','#46f'][k];
  return `<polyline class="ax" stroke="${col}" points="${a[0]},${a[1]} ${b[0]},${b[1]}"/>`;
 }).join('');
 const last=proj(path[n-1]);
 view.innerHTML=lms+`<polyline class="path" points="${pts}"/>`+kfs+
  `<circle class="cur" cx="${last[0]}" cy="${last[1]}" r="0.02"/>`+axes;
}
async function tick(){
 try{
  const s=await (await fetch('state.json')).json();
  S=s;
  const rows=[['frames',s.n_frames],['keyframes',s.n_keyframes],
   ['landmarks',s.n_landmarks],['fps',fmt(s.fps,1)],
   ['t (s)',fmt(s.t_ns/1e9,3)],
   ['pos (m)',s.position.map(v=>fmt(v)).join(' ')],
   ['speed (m/s)',fmt(s.speed,3)],
   ['sigma_t (m)',fmt(s.sigma_translation,5)]];
  document.getElementById('stats').innerHTML=
   rows.map(r=>`<tr><td>${r[0]}</td><td>${r[1]}</td></tr>`).join('');
  draw(s);
 }catch(e){}
}
setInterval(tick,500); tick();
</script></body></html>
"""


class LiveViz:
    """In-process live odometry/path/map publisher + HTTP viewer.

    ``port=0`` binds an ephemeral port (read ``.port`` after construction);
    the server thread is a daemon so it never blocks interpreter exit, but
    call ``close()`` for deterministic shutdown (tests do).
    """

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        max_path: int = 4096,
        max_landmarks: int = 4096,
    ):
        self._lock = threading.Lock()
        self._max_path = int(max_path)
        self._max_landmarks = int(max_landmarks)
        self._path: list = []  # [x,y,z] camera-in-world
        self._keyframes: list = []
        self._landmarks: list = []
        self._n_frames = 0
        # true counter: the _keyframes list is decimated at max_path for
        # display, so its length under-reports on long runs (n_frames is a
        # counter for the same reason)
        self._n_keyframes = 0
        self._latest: dict = {
            "t_ns": 0,
            "position": [0.0, 0.0, 0.0],
            "quaternion": [0.0, 0.0, 0.0, 1.0],
            "sigma_translation": 0.0,
            "speed": 0.0,
            "fps": 0.0,
        }
        self._last_wall: Optional[float] = None
        self._fps_ema = 0.0

        viz = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # route HTTP chatter to our logger
                _log.debug("http: " + a[0], *a[1:])

            def do_GET(self):
                if self.path.split("?")[0] in ("/state.json", "/state"):
                    body = viz.state_json().encode()
                    ctype = "application/json"
                elif self.path in ("/", "/index.html"):
                    body = _PAGE.encode()
                    ctype = "text/html; charset=utf-8"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, int(port)), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="vslam-viz", daemon=True
        )
        self._thread.start()
        _log.info("live viz at http://%s:%d/", host, self.port)

    # -- publisher surface (NodeMapping::publish parity) ---------------------

    def publish_odometry(
        self,
        t_ns: int,
        pose_w2c: np.ndarray,
        cov: Optional[np.ndarray] = None,
        twist: Optional[np.ndarray] = None,
        wall_time: Optional[float] = None,
    ) -> None:
        """Per-frame odometry: pose (world->camera, inverted for display as
        the reference does at NodeMapping.cpp:238), optional 6x6 covariance
        (sigma_translation readout = sqrt trace of the 3x3 translation
        block), optional 6-twist (|v| readout = /odom twist role)."""
        T = _cam_in_world(pose_w2c)
        pos = T[:3, 3].tolist()
        quat = list(matrix_to_quat(T[:3, :3]))
        sigma_t = 0.0
        if cov is not None:
            c = np.asarray(cov, dtype=np.float64)
            sigma_t = float(np.sqrt(max(np.trace(c[:3, :3]), 0.0)))
        speed = 0.0
        if twist is not None:
            speed = float(np.linalg.norm(np.asarray(twist, np.float64)[:3]))
        if wall_time is None:
            import time

            wall_time = time.perf_counter()
        with self._lock:
            if self._last_wall is not None:
                dt = max(wall_time - self._last_wall, 1e-6)
                inst = 1.0 / dt
                self._fps_ema = (
                    inst if self._fps_ema == 0.0
                    else 0.9 * self._fps_ema + 0.1 * inst
                )
            self._last_wall = wall_time
            self._n_frames += 1
            self._path.append(pos)
            if len(self._path) > self._max_path:
                self._path = self._path[::2]
            self._latest.update(
                t_ns=int(t_ns),
                position=pos,
                quaternion=quat,
                sigma_translation=sigma_t,
                speed=speed,
                fps=round(self._fps_ema, 2),
            )

    def publish_keyframe(self, t_ns: int, pose_w2c: np.ndarray) -> None:
        """Keyframe marker (the reference's keyframe TF/marker role)."""
        pos = _cam_in_world(pose_w2c)[:3, 3].tolist()
        with self._lock:
            self._n_keyframes += 1
            self._keyframes.append(pos)
            if len(self._keyframes) > self._max_path:
                self._keyframes = self._keyframes[::2]

    def publish_landmarks(self, points: np.ndarray) -> None:
        """Replace the displayed map-point cloud (world-frame Nx3). Capped at
        ``max_landmarks`` by uniform subsampling."""
        pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
        if len(pts) > self._max_landmarks:
            idx = np.linspace(0, len(pts) - 1, self._max_landmarks).astype(int)
            pts = pts[idx]
        with self._lock:
            self._landmarks = pts.tolist()

    # -- state bus ------------------------------------------------------------

    def state(self) -> dict:
        with self._lock:
            return {
                "n_frames": self._n_frames,
                "n_keyframes": self._n_keyframes,
                "n_landmarks": len(self._landmarks),
                "path": list(self._path),
                "keyframes": list(self._keyframes),
                "landmarks": list(self._landmarks),
                **self._latest,
            }

    def state_json(self) -> str:
        return json.dumps(self.state())

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)
