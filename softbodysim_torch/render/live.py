"""Live browser viewport: stream positions into the WebGL player.

The reference's rendering layer is a real-time viewport -- the player loop
pulls solver buffers every frame (Assets/Shaders/SoftBodyGpuRenderLit.shader
:58-97 via SoftBodyManager.cs:102-120).  Here the sim process
publishes each frame's surface positions into a tiny stdlib HTTP server and
the browser player (same WebGL renderer as render/viewer.py's offline
export) polls binary Float32 frames at display rate.  Zero dependencies, one
port, works over an SSH tunnel.

Usage::

    lv = LiveViewer(topo.surface_tris, eng.positions)   # starts the server
    while running:
        eng.step(dt)
        lv.publish()                 # ship the latest positions
    lv.stop()

CLI: ``python -m softbodysim_torch scene NAME --view`` and
``... serve --view`` (positions published per MSG_STEP).
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
 body{{margin:0;background:#10131a;color:#dde;font:13px system-ui}}
 #hud{{position:fixed;left:10px;top:10px;user-select:none}}
 canvas{{display:block;width:100vw;height:100vh}}</style></head><body>
<canvas id="c"></canvas>
<div id="hud">{title} &mdash; LIVE &mdash; <span id="st">connecting</span>
 &mdash; drag to orbit, wheel to zoom</div>
<script>
const NV={nv};
function decode(b64){{const s=atob(b64);const a=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return a.buffer;}}
const idx=new Uint32Array(decode("{idx_b64}"));
let pos=new Float32Array(NV*3);
const cv=document.getElementById("c"),gl=cv.getContext("webgl2");
const vs=`#version 300 es
 in vec3 p;uniform mat4 mvp;out vec3 wp;
 void main(){{wp=p;gl_Position=mvp*vec4(p,1.0);}}`;
const fs=`#version 300 es
 precision highp float;in vec3 wp;out vec4 o;
 void main(){{vec3 n=normalize(cross(dFdx(wp),dFdy(wp)));
  float d=max(dot(n,normalize(vec3(.4,.8,.5))),0.0);
  vec3 base=vec3(.35,.55,.9);
  o=vec4(base*(0.25+0.75*d)+vec3(pow(d,24.0)*.3),1.0);}}`;
function sh(t,s){{const h=gl.createShader(t);gl.shaderSource(h,s);gl.compileShader(h);
 if(!gl.getShaderParameter(h,gl.COMPILE_STATUS))throw gl.getShaderInfoLog(h);return h;}}
const pr=gl.createProgram();gl.attachShader(pr,sh(gl.VERTEX_SHADER,vs));
gl.attachShader(pr,sh(gl.FRAGMENT_SHADER,fs));gl.linkProgram(pr);gl.useProgram(pr);
const vb=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,vb);
gl.bufferData(gl.ARRAY_BUFFER,NV*12,gl.DYNAMIC_DRAW);
const loc=gl.getAttribLocation(pr,"p");gl.enableVertexAttribArray(loc);
gl.vertexAttribPointer(loc,3,gl.FLOAT,false,0,0);
const ib=gl.createBuffer();gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,ib);
gl.bufferData(gl.ELEMENT_ARRAY_BUFFER,idx,gl.STATIC_DRAW);
gl.enable(gl.DEPTH_TEST);
let cx=0,cy=0,cz=0,R=1,haveBounds=false;
function bounds(){{let lo=[1e9,1e9,1e9],hi=[-1e9,-1e9,-1e9];
 for(let i=0;i<NV;i++)for(let k=0;k<3;k++){{const v=pos[i*3+k];
  if(v<lo[k])lo[k]=v;if(v>hi[k])hi[k]=v;}}
 cx=(lo[0]+hi[0])/2;cy=(lo[1]+hi[1])/2;cz=(lo[2]+hi[2])/2;
 R=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2])*1.2+1e-3;}}
let yaw=0.7,pitch=0.35,dist=2.2,drag=false,lx=0,ly=0;
cv.onmousedown=e=>{{drag=true;lx=e.clientX;ly=e.clientY;}};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{{if(!drag)return;yaw+=(e.clientX-lx)*.008;
 pitch=Math.min(1.5,Math.max(-1.5,pitch+(e.clientY-ly)*.008));lx=e.clientX;ly=e.clientY;}};
cv.onwheel=e=>{{dist*=Math.exp(e.deltaY*.001);e.preventDefault();}};
function mat(){{const a=innerWidth/innerHeight,f=1/Math.tan(.4),zn=.01*R,zf=40*R;
 const ex=cx+dist*R*Math.cos(pitch)*Math.sin(yaw),
       ey=cy+dist*R*Math.sin(pitch),
       ez=cz+dist*R*Math.cos(pitch)*Math.cos(yaw);
 let zx=ex-cx,zy=ey-cy,zz=ez-cz;const zl=Math.hypot(zx,zy,zz);zx/=zl;zy/=zl;zz/=zl;
 let xx=zz,xy=0,xz=-zx;const xl=Math.hypot(xx,xy,xz)||1;xx/=xl;xz/=xl;
 const yx=zy*xz-zz*xy,yy=zz*xx-zx*xz,yz=zx*xy-zy*xx;
 const v=[xx,yx,zx,0, xy,yy,zy,0, xz,yz,zz,0,
  -(xx*ex+xy*ey+xz*ez),-(yx*ex+yy*ey+yz*ez),-(zx*ex+zy*ey+zz*ez),1];
 const A=(zf+zn)/(zn-zf),B=2*zf*zn/(zn-zf);
 const p=[f/a,0,0,0, 0,f,0,0, 0,0,A,-1, 0,0,B,0];
 const m=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){{let s=0;
  for(let k=0;k<4;k++)s+=p[k*4+j]*v[i*4+k];m[i*4+j]=s;}}
 return m;}}
const ust=document.getElementById("st");
let frames=0,lastN=-1,dirty=false;
async function pump(){{
 while(true){{
  try{{
   const r=await fetch("/frame");
   const n=+r.headers.get("X-Frame-Index");
   const buf=await r.arrayBuffer();
   if(buf.byteLength===NV*12&&n!==lastN){{
    pos=new Float32Array(buf);lastN=n;dirty=true;frames++;
    if(!haveBounds){{bounds();haveBounds=true;}}
   }} else await new Promise(s=>setTimeout(s,15));
  }}catch(e){{ust.textContent="disconnected";
   await new Promise(s=>setTimeout(s,500));}}
 }}}}
pump();
setInterval(()=>{{ust.textContent=frames+" fps";frames=0;}},1000);
function draw(){{
 cv.width=innerWidth*devicePixelRatio;cv.height=innerHeight*devicePixelRatio;
 gl.viewport(0,0,cv.width,cv.height);
 gl.bindBuffer(gl.ARRAY_BUFFER,vb);
 if(dirty){{gl.bufferSubData(gl.ARRAY_BUFFER,0,pos);dirty=false;}}
 gl.clearColor(.063,.075,.10,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.uniformMatrix4fv(gl.getUniformLocation(pr,"mvp"),false,mat());
 gl.drawElements(gl.TRIANGLES,idx.length,gl.UNSIGNED_INT,0);
 requestAnimationFrame(draw);}}
requestAnimationFrame(draw);
</script></body></html>
"""


class LiveViewer:
    """Publish frames to a browser viewport over plain HTTP.

    triangles     : (T, 3) surface indices (concatenate multi-body surfaces
                    with vertex offsets, like AnimationRecorder)
    positions_fn  : () -> (V, 3) latest positions (called by publish())
    """

    def __init__(self, triangles, positions_fn: Optional[Callable] = None,
                 host: str = "127.0.0.1", port: int = 8900,
                 title: str = "softbodysim_torch live"):
        self._tris = np.ascontiguousarray(
            np.asarray(triangles, np.uint32)).reshape(-1, 3)
        self._positions_fn = positions_fn
        self._lock = threading.Lock()
        self._frame = b""
        self._nv = 0
        self._n = 0
        self._title = title

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # quiet
                pass

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    body = viewer._page().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/frame"):
                    with viewer._lock:
                        body, n = viewer._frame, viewer._n
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("X-Frame-Index", str(n))
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/stats"):
                    body = json.dumps(
                        {"frames": viewer._n, "nv": viewer._nv}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        if positions_fn is not None:
            self.publish()

    def _page(self) -> str:
        return _PAGE.format(
            title=self._title, nv=self._nv,
            idx_b64=base64.b64encode(self._tris.tobytes()).decode())

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/"

    @property
    def frames_published(self) -> int:
        return self._n

    def publish(self, positions=None) -> "LiveViewer":
        """Ship the latest positions (or positions_fn()) to the viewer."""
        if positions is None:
            positions = self._positions_fn()
        arr = np.ascontiguousarray(np.asarray(positions, np.float32))
        with self._lock:
            self._frame = arr.tobytes()
            self._nv = len(arr)
            self._n += 1
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
