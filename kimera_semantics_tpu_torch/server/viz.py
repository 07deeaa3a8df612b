"""Live incremental-mesh visualization for `stream` mode.

Counterpart: kimera_semantics_tpu/server/viz.py (MeshLayerCache,
LiveMeshWriter, MeshHTTPStreamer), host-side and unchanged.

The reference's product loop publishes an incremental `voxblox_msgs/Mesh`
topic consumed by rviz (kimera_semantics.launch:131 `update_mesh_every_n_sec`,
rviz/kimera_semantics_gt.rviz). There is no ROS here, so the
equivalents are:

  - `MeshLayerCache`: the voxblox MeshLayer contract — per-block triangle
    sets; an incremental update replaces exactly the re-meshed blocks and
    keeps the rest, so consumers always see the full growing mesh.
  - `LiveMeshWriter`: atomically rewrites a PLY file after each update
    (tmp + os.replace, so a watching viewer never reads a torn file) and can
    keep a rotating `mesh_0001.ply...` series for scrubbing.
  - `MeshHTTPStreamer`: a stdlib ThreadingHTTPServer that serves the latest
    mesh at `/mesh.ply`, stats at `/stats.json`, and a self-contained
    WebGL-free HTML viewer at `/` (vanilla JS: fetches + parses the binary
    PLY, software-projects the triangle soup onto a <canvas>, auto-refreshes)
    — point any browser at it while `stream` runs.

Wireup lives in server/pipeline.py (`ServerConfig.live_mesh_path/_port`);
everything here is host-side and runs off the existing `mesh_callbacks`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from ..ops.mesh import Mesh


class MeshLayerCache:
    """Per-block triangle cache; `update` applies an incremental extraction
    (meshed block rows + per-triangle rows) and `full_mesh` concatenates the
    current state — voxblox MeshLayer semantics."""

    def __init__(self):
        self._blocks: Dict[int, Tuple[np.ndarray, np.ndarray,
                                      Optional[np.ndarray]]] = {}
        self.version = 0

    def update(self, mesh: Mesh, meshed_rows: np.ndarray,
               tri_rows: np.ndarray) -> None:
        v = mesh.vertices.reshape(-1, 3, 3)
        c = mesh.colors.reshape(-1, 3, 3)
        n = (mesh.normals.reshape(-1, 3, 3)
             if mesh.normals is not None else None)
        # Every re-meshed block is replaced — including ones that now emit
        # zero triangles (e.g. carved free space).
        for row in np.asarray(meshed_rows).tolist():
            self._blocks.pop(row, None)
        if len(tri_rows):
            order = np.argsort(tri_rows, kind="stable")
            sorted_rows = tri_rows[order]
            bounds = np.searchsorted(sorted_rows,
                                     np.unique(sorted_rows))
            uniq = np.unique(sorted_rows)
            for i, row in enumerate(uniq.tolist()):
                lo = bounds[i]
                hi = bounds[i + 1] if i + 1 < len(bounds) else len(order)
                idx = order[lo:hi]
                self._blocks[row] = (v[idx], c[idx],
                                     n[idx] if n is not None else None)
        self.version += 1

    @property
    def num_blocks(self) -> int:
        return len(self._blocks)

    def full_mesh(self) -> Mesh:
        if not self._blocks:
            z = np.zeros((0, 3), np.float32)
            return Mesh(z, np.zeros((0, 3), np.uint8),
                        np.zeros((0, 3), np.int32))
        vs, cs, ns = [], [], []
        has_n = True
        for v, c, n in self._blocks.values():
            vs.append(v.reshape(-1, 3))
            cs.append(c.reshape(-1, 3))
            if n is None:
                has_n = False
            else:
                ns.append(n.reshape(-1, 3))
        v = np.concatenate(vs).astype(np.float32)
        return Mesh(
            vertices=v,
            colors=np.concatenate(cs).astype(np.uint8),
            triangles=np.arange(len(v), dtype=np.int32).reshape(-1, 3),
            normals=np.concatenate(ns).astype(np.float32) if has_n else None)


class LiveMeshWriter:
    """Atomic rotating PLY emitter: `path` always holds the newest full mesh;
    with keep>0, also `path_stem.NNNN.ply` snapshots (oldest pruned)."""

    def __init__(self, path: str, keep: int = 0):
        self.path = path
        self.keep = keep
        self._seq = 0

    def write(self, mesh: Mesh) -> None:
        from ..io import ply as ply_io
        tmp = self.path + ".tmp"
        ply_io.write_ply(tmp, mesh.vertices, mesh.colors, mesh.triangles,
                         mesh.normals)
        os.replace(tmp, self.path)
        if self.keep > 0:
            stem, ext = os.path.splitext(self.path)
            snap = f"{stem}.{self._seq:04d}{ext}"
            data = open(self.path, "rb").read()
            with open(snap + ".tmp", "wb") as f:
                f.write(data)
            os.replace(snap + ".tmp", snap)
            old = self._seq - self.keep
            if old >= 0:
                try:
                    os.remove(f"{stem}.{old:04d}{ext}")
                except OSError:
                    pass
            self._seq += 1


_VIEWER_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>kimera_semantics_tpu_torch live mesh</title>
<style>
 body{margin:0;background:#111;color:#ccc;font:13px monospace;overflow:hidden}
 #hud{position:fixed;top:8px;left:10px;pointer-events:none;white-space:pre}
 canvas{display:block}
</style></head><body>
<div id="hud">loading…</div><canvas id="cv"></canvas>
<script>
"use strict";
const cv=document.getElementById("cv"),hud=document.getElementById("hud");
const ctx=cv.getContext("2d");
let tris=null,center=[0,0,0],scale=1,nTri=0,version=-1;
let yaw=0.7,pitch=0.5,dist=2.6,auto=true;
function resize(){cv.width=innerWidth;cv.height=innerHeight;}
addEventListener("resize",resize);resize();
cv.addEventListener("mousedown",e=>{auto=false;let px=e.clientX,py=e.clientY;
 const mv=ev=>{yaw+=(ev.clientX-px)*.01;pitch+=(ev.clientY-py)*.01;
  pitch=Math.max(-1.5,Math.min(1.5,pitch));px=ev.clientX;py=ev.clientY;};
 const up=()=>{removeEventListener("mousemove",mv);removeEventListener("mouseup",up);};
 addEventListener("mousemove",mv);addEventListener("mouseup",up);});
cv.addEventListener("wheel",e=>{dist*=Math.exp(e.deltaY*.001);});
function parsePLY(buf){
 const txt=new TextDecoder().decode(buf.slice(0,2048));
 const end=txt.indexOf("end_header\\n");if(end<0)return null;
 const head=txt.slice(0,end).split("\\n");let n=0,fmt="";
 for(const l of head){const t=l.split(" ");
  if(t[0]==="format")fmt=t[1];
  if(t[0]==="element"&&t[1]==="vertex")n=+t[2];}
 const off=end+"end_header\\n".length;
 // vertex layout written by io/ply.py: x y z f32 + r g b u8 (+nx ny nz f32)
 const hasN=head.some(l=>l.includes("property float nx"));
 const stride=hasN?27:15;
 const dv=new DataView(buf,off);
 const v=new Float32Array(n*3),c=new Uint8Array(n*3);
 for(let i=0;i<n;i++){const b=i*stride;
  v[3*i]=dv.getFloat32(b,true);v[3*i+1]=dv.getFloat32(b+4,true);
  v[3*i+2]=dv.getFloat32(b+8,true);
  const cb=b+(hasN?24:12);
  c[3*i]=dv.getUint8(cb);c[3*i+1]=dv.getUint8(cb+1);c[3*i+2]=dv.getUint8(cb+2);}
 return {v,c,n};
}
async function refresh(){
 try{
  const st=await (await fetch("stats.json")).json();
  if(st.version!==version){
   version=st.version;
   const buf=await (await fetch("mesh.ply")).arrayBuffer();
   const m=parsePLY(buf);
   if(m){tris=m;nTri=m.n/3|0;
    let lo=[1e9,1e9,1e9],hi=[-1e9,-1e9,-1e9];
    for(let i=0;i<m.n;i++)for(let a=0;a<3;a++){
     const x=m.v[3*i+a];if(x<lo[a])lo[a]=x;if(x>hi[a])hi[a]=x;}
    center=[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
    scale=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],1e-3);}
  }
  hud.textContent=`triangles ${nTri}  blocks ${st.blocks}  frame ${st.frames}`
   +`  v${st.version}\\ndrag: orbit  wheel: zoom`;
 }catch(e){hud.textContent="waiting for stream… "+e;}
 setTimeout(refresh,1000);
}
function draw(){
 requestAnimationFrame(draw);
 if(auto)yaw+=0.004;
 ctx.fillStyle="#111";ctx.fillRect(0,0,cv.width,cv.height);
 if(!tris)return;
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 const f=cv.height/(1.2*scale)* (2.6/dist);
 const n=tris.n,v=tris.v,c=tris.c;
 const xs=new Float32Array(n),ys=new Float32Array(n),zs=new Float32Array(n);
 for(let i=0;i<n;i++){
  let x=v[3*i]-center[0],y=v[3*i+1]-center[1],z=v[3*i+2]-center[2];
  let x1=cy*x+sy*y, y1=-sy*x+cy*y;
  let y2=cp*y1+sp*z, z2=-sp*y1+cp*z;
  xs[i]=cv.width/2+f*x1; ys[i]=cv.height/2-f*z2; zs[i]=y2;}
 const t=n/3|0,order=new Int32Array(t),depth=new Float32Array(t);
 for(let i=0;i<t;i++){order[i]=i;depth[i]=zs[3*i]+zs[3*i+1]+zs[3*i+2];}
 order.sort((a,b)=>depth[b]-depth[a]);
 for(let k=0;k<t;k++){const i=order[k],a=3*i,b=3*i+1,d=3*i+2;
  const sh=1-Math.min(.45,Math.max(0,(depth[i]/scale+1)/4));
  ctx.fillStyle=`rgb(${c[3*a]*sh|0},${c[3*a+1]*sh|0},${c[3*a+2]*sh|0})`;
  ctx.beginPath();ctx.moveTo(xs[a],ys[a]);ctx.lineTo(xs[b],ys[b]);
  ctx.lineTo(xs[d],ys[d]);ctx.closePath();ctx.fill();}
}
refresh();draw();
</script></body></html>
"""


class MeshHTTPStreamer:
    """Background HTTP server: `/` HTML viewer, `/mesh.ply` latest bytes,
    `/stats.json` {version, blocks, frames, triangles}. Thread-safe single
    latest-snapshot buffer; daemon threads die with the process."""

    def __init__(self, port: int = 8008, host: str = "127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._lock = threading.Lock()
        self._ply = b""
        self._stats = {"version": 0, "blocks": 0, "frames": 0,
                       "triangles": 0, "t": time.time()}
        streamer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path in ("/", "/index.html"):
                    body = _VIEWER_HTML.encode()
                    ctype = "text/html; charset=utf-8"
                elif path == "/mesh.ply":
                    with streamer._lock:
                        body = streamer._ply
                    ctype = "application/octet-stream"
                elif path == "/stats.json":
                    with streamer._lock:
                        body = json.dumps(streamer._stats).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True,
                                        name="ksd-mesh-http")
        self._thread.start()

    def publish(self, mesh: Mesh, version: int, blocks: int,
                frames: int) -> None:
        from ..io import ply as ply_io
        data = ply_io.ply_bytes(mesh.vertices, mesh.colors, mesh.triangles,
                                mesh.normals)
        with self._lock:
            self._ply = data
            self._stats = {"version": version, "blocks": blocks,
                           "frames": frames,
                           "triangles": int(mesh.num_triangles),
                           "t": time.time()}

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
