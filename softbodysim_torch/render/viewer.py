"""Playable animation export: one self-contained HTML file, zero deps.

The reference's L8 is a live Unity viewport (SoftBodyGpuRenderLit.shader);
the headless analog needs a user-visible artifact, so rollouts export to
a single .html with the frame buffers embedded (base64 Float32Array) and a
~100-line WebGL2 renderer: orbit camera, play/pause/scrub, flat shading from
fragment derivatives (no per-frame normal upload -- the GPU derives normals,
like the reference's K_UpdateNormals stage but free).

Multi-body scenes concatenate their surface meshes into one buffer.
"""

from __future__ import annotations

import base64
import json
from typing import Optional, Sequence

import numpy as np

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
 body{{margin:0;background:#10131a;color:#dde;font:13px system-ui}}
 #hud{{position:fixed;left:10px;top:10px;user-select:none}}
 #bar{{position:fixed;left:10px;bottom:10px;right:10px;display:flex;gap:8px;align-items:center}}
 input[type=range]{{flex:1}} button{{background:#2a3140;color:#dde;border:0;padding:4px 12px;border-radius:4px}}
 canvas{{display:block;width:100vw;height:100vh}}</style></head><body>
<canvas id="c"></canvas>
<div id="hud">{title} &mdash; {nv} verts, {nf} frames @ {fps} fps &mdash; drag to orbit, wheel to zoom</div>
<div id="bar"><button id="play">pause</button><input id="seek" type="range" min="0" max="{nfm1}" value="0"><span id="fr">0</span></div>
<script>
const NV={nv},NF={nf},FPS={fps};
function decode(b64){{const s=atob(b64);const a=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return a.buffer;}}
const pos=new Float32Array(decode("{pos_b64}"));
const idx=new Uint32Array(decode("{idx_b64}"));
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
let cx=0,cy=0,cz=0,R=1;{{let lo=[1e9,1e9,1e9],hi=[-1e9,-1e9,-1e9];
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
const useek=document.getElementById("seek"),ufr=document.getElementById("fr"),
      ubtn=document.getElementById("play");
let playing=true,t0=performance.now(),frame=0;
ubtn.onclick=()=>{{playing=!playing;ubtn.textContent=playing?"pause":"play";}};
useek.oninput=()=>{{frame=+useek.value;playing=false;ubtn.textContent="play";}};
function draw(now){{
 cv.width=innerWidth*devicePixelRatio;cv.height=innerHeight*devicePixelRatio;
 gl.viewport(0,0,cv.width,cv.height);
 if(playing)frame=Math.floor((now-t0)/1000*FPS)%NF;
 useek.value=frame;ufr.textContent=frame;
 gl.bindBuffer(gl.ARRAY_BUFFER,vb);
 gl.bufferSubData(gl.ARRAY_BUFFER,0,pos.subarray(frame*NV*3,(frame+1)*NV*3));
 gl.clearColor(.063,.075,.10,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.uniformMatrix4fv(gl.getUniformLocation(pr,"mvp"),false,mat());
 gl.drawElements(gl.TRIANGLES,idx.length,gl.UNSIGNED_INT,0);
 requestAnimationFrame(draw);}}
requestAnimationFrame(draw);
</script></body></html>
"""


_HTML_LIT = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
 body{{margin:0;background:#10131a;color:#dde;font:13px system-ui}}
 #hud{{position:fixed;left:10px;top:10px;user-select:none}}
 #bar{{position:fixed;left:10px;bottom:10px;right:10px;display:flex;gap:8px;align-items:center}}
 input[type=range]{{flex:1}} button{{background:#2a3140;color:#dde;border:0;padding:4px 12px;border-radius:4px}}
 canvas{{display:block;width:100vw;height:100vh}}</style></head><body>
<canvas id="c"></canvas>
<div id="hud">{title} &mdash; {nv} verts, {nf} frames @ {fps} fps &mdash; textured Blinn-Phong</div>
<div id="bar"><button id="play">pause</button><input id="seek" type="range" min="0" max="{nfm1}" value="0"><span id="fr">0</span></div>
<script>
const NV={nv},NF={nf},FPS={fps},TW={tw},TH={th};
function decode(b64){{const s=atob(b64);const a=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return a.buffer;}}
const pos=new Float32Array(decode("{pos_b64}"));
const idx=new Uint32Array(decode("{idx_b64}"));
const uv=new Float32Array(decode("{uv_b64}"));
const tex=new Uint8Array(decode("{tex_b64}"));
const cv=document.getElementById("c"),gl=cv.getContext("webgl2");
// Blinn-Phong straight from the sim buffers -- the WebGL analog of the
// reference's SoftBodyGpuRenderLit.shader:58-97 (ambient + N.L diffuse +
// pow(N.H) specular, all over a sampled base texture).
const vs=`#version 300 es
 in vec3 p;in vec3 n;in vec2 t;uniform mat4 mvp;
 out vec3 wp;out vec3 wn;out vec2 wt;
 void main(){{wp=p;wn=n;wt=t;gl_Position=mvp*vec4(p,1.0);}}`;
const fs=`#version 300 es
 precision highp float;in vec3 wp;in vec3 wn;in vec2 wt;
 uniform vec3 eye;uniform sampler2D tx;out vec4 o;
 void main(){{
  vec3 N=normalize(wn);
  vec3 L=normalize(vec3(.4,.8,.5));
  vec3 V=normalize(eye-wp);
  vec3 H=normalize(L+V);
  if(dot(N,V)<0.0)N=-N;
  vec3 base=texture(tx,wt).rgb;
  float ndl=max(dot(N,L),0.0);
  float spec=pow(max(dot(N,H),0.0),48.0);
  vec3 col=0.25*base+ndl*base+spec*vec3(.35);
  o=vec4(col,1.0);}}`;
function sh(t,s){{const h=gl.createShader(t);gl.shaderSource(h,s);gl.compileShader(h);
 if(!gl.getShaderParameter(h,gl.COMPILE_STATUS))throw gl.getShaderInfoLog(h);return h;}}
const pr=gl.createProgram();gl.attachShader(pr,sh(gl.VERTEX_SHADER,vs));
gl.attachShader(pr,sh(gl.FRAGMENT_SHADER,fs));gl.linkProgram(pr);gl.useProgram(pr);
function attr(name,data,sz,dyn){{const b=gl.createBuffer();
 gl.bindBuffer(gl.ARRAY_BUFFER,b);
 gl.bufferData(gl.ARRAY_BUFFER,data,dyn?gl.DYNAMIC_DRAW:gl.STATIC_DRAW);
 const l=gl.getAttribLocation(pr,name);gl.enableVertexAttribArray(l);
 gl.vertexAttribPointer(l,sz,gl.FLOAT,false,0,0);return b;}}
const vb=attr("p",NV*12,3,true);
const nb=attr("n",NV*12,3,true);
attr("t",uv,2,false);
const ib=gl.createBuffer();gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,ib);
gl.bufferData(gl.ELEMENT_ARRAY_BUFFER,idx,gl.STATIC_DRAW);
const txo=gl.createTexture();gl.bindTexture(gl.TEXTURE_2D,txo);
gl.texImage2D(gl.TEXTURE_2D,0,gl.RGB,TW,TH,0,gl.RGB,gl.UNSIGNED_BYTE,tex);
gl.generateMipmap(gl.TEXTURE_2D);
gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_MIN_FILTER,gl.LINEAR_MIPMAP_LINEAR);
gl.enable(gl.DEPTH_TEST);
// per-frame area-weighted vertex normals (the reference's K_UpdateNormals
// compute stage, SoftBodyCompute.compute)
const nrm=new Float32Array(NV*3);
function normals(fp){{nrm.fill(0);
 for(let f=0;f<idx.length;f+=3){{const a=idx[f],b=idx[f+1],c=idx[f+2];
  const ax=fp[a*3],ay=fp[a*3+1],az=fp[a*3+2];
  const ux=fp[b*3]-ax,uy=fp[b*3+1]-ay,uz=fp[b*3+2]-az;
  const vx=fp[c*3]-ax,vy=fp[c*3+1]-ay,vz=fp[c*3+2]-az;
  const nx=uy*vz-uz*vy,ny=uz*vx-ux*vz,nz=ux*vy-uy*vx;
  nrm[a*3]+=nx;nrm[a*3+1]+=ny;nrm[a*3+2]+=nz;
  nrm[b*3]+=nx;nrm[b*3+1]+=ny;nrm[b*3+2]+=nz;
  nrm[c*3]+=nx;nrm[c*3+1]+=ny;nrm[c*3+2]+=nz;}}}}
let cx=0,cy=0,cz=0,R=1;{{let lo=[1e9,1e9,1e9],hi=[-1e9,-1e9,-1e9];
 for(let i=0;i<NV;i++)for(let k=0;k<3;k++){{const v=pos[i*3+k];
  if(v<lo[k])lo[k]=v;if(v>hi[k])hi[k]=v;}}
 cx=(lo[0]+hi[0])/2;cy=(lo[1]+hi[1])/2;cz=(lo[2]+hi[2])/2;
 R=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2])*1.2+1e-3;}}
let yaw=0.7,pitch=0.35,dist=2.2,drag=false,lx=0,ly=0,eye=[0,0,0];
cv.onmousedown=e=>{{drag=true;lx=e.clientX;ly=e.clientY;}};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{{if(!drag)return;yaw+=(e.clientX-lx)*.008;
 pitch=Math.min(1.5,Math.max(-1.5,pitch+(e.clientY-ly)*.008));lx=e.clientX;ly=e.clientY;}};
cv.onwheel=e=>{{dist*=Math.exp(e.deltaY*.001);e.preventDefault();}};
function mat(){{const a=innerWidth/innerHeight,f=1/Math.tan(.4),zn=.01*R,zf=40*R;
 const ex=cx+dist*R*Math.cos(pitch)*Math.sin(yaw),
       ey=cy+dist*R*Math.sin(pitch),
       ez=cz+dist*R*Math.cos(pitch)*Math.cos(yaw);
 eye=[ex,ey,ez];
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
const useek=document.getElementById("seek"),ufr=document.getElementById("fr"),
      ubtn=document.getElementById("play");
let playing=true,t0=performance.now(),frame=0,lastFrame=-1;
ubtn.onclick=()=>{{playing=!playing;ubtn.textContent=playing?"pause":"play";}};
useek.oninput=()=>{{frame=+useek.value;playing=false;ubtn.textContent="play";}};
function draw(now){{
 cv.width=innerWidth*devicePixelRatio;cv.height=innerHeight*devicePixelRatio;
 gl.viewport(0,0,cv.width,cv.height);
 if(playing)frame=Math.floor((now-t0)/1000*FPS)%NF;
 useek.value=frame;ufr.textContent=frame;
 const fp=pos.subarray(frame*NV*3,(frame+1)*NV*3);
 if(frame!=lastFrame){{normals(fp);lastFrame=frame;
  gl.bindBuffer(gl.ARRAY_BUFFER,vb);gl.bufferSubData(gl.ARRAY_BUFFER,0,fp);
  gl.bindBuffer(gl.ARRAY_BUFFER,nb);gl.bufferSubData(gl.ARRAY_BUFFER,0,nrm);}}
 gl.clearColor(.063,.075,.10,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.uniformMatrix4fv(gl.getUniformLocation(pr,"mvp"),false,mat());
 gl.uniform3fv(gl.getUniformLocation(pr,"eye"),eye);
 gl.drawElements(gl.TRIANGLES,idx.length,gl.UNSIGNED_INT,0);
 requestAnimationFrame(draw);}}
requestAnimationFrame(draw);
</script></body></html>
"""


def checker_texture(size: int = 256, tiles: int = 8,
                    c0=(225, 170, 60), c1=(40, 70, 150)) -> np.ndarray:
    """A procedural RGB checker (H, W, 3) u8 -- the stand-in texture when
    the scene has UVs but no image (the reference repo ships cirno's .meta
    but not the .jpg itself)."""
    y, x = np.mgrid[0:size, 0:size]
    m = ((x * tiles // size + y * tiles // size) % 2).astype(bool)
    img = np.empty((size, size, 3), np.uint8)
    img[~m] = np.asarray(c0, np.uint8)
    img[m] = np.asarray(c1, np.uint8)
    return img


def export_html_lit(path: str, frames: np.ndarray, triangles: np.ndarray,
                    uvs: np.ndarray, texture=None, fps: int = 30,
                    title: str = "softbodysim_torch rollout (lit)"):
    """Textured Blinn-Phong playable viewer -- the analog of the
    reference's lit render path (Assets/Shaders/SoftBodyGpuRenderLit.
    shader:58-97), consuming the per-vertex UVs that
    ``render/uv_transfer.py`` / ``render/embedding.py`` produce.

    frames    : (F, V, 3) positions per frame
    triangles : (T, 3) surface indices into V
    uvs       : (V, 2) texture coordinates
    texture   : (H, W, 3) uint8 RGB array; None -> procedural checker.
    Smooth per-vertex normals are recomputed per frame in the viewer
    (the K_UpdateNormals stage, free on the render GPU).
    """
    frames = np.ascontiguousarray(np.asarray(frames, np.float32))
    tris = np.ascontiguousarray(
        np.asarray(triangles, np.uint32)).reshape(-1, 3)
    f, v, _ = frames.shape
    uvs = np.ascontiguousarray(np.asarray(uvs, np.float32)).reshape(v, 2)
    if texture is None:
        texture = checker_texture()
    texture = np.ascontiguousarray(np.asarray(texture, np.uint8))
    if texture.ndim != 3 or texture.shape[2] != 3:
        raise ValueError(f"texture must be (H, W, 3) u8, "
                         f"got {texture.shape}")
    th, tw = texture.shape[:2]
    if (tw & (tw - 1)) or (th & (th - 1)):
        raise ValueError("texture sides must be powers of two (WebGL "
                         f"mipmaps); got {tw}x{th}")
    html = _HTML_LIT.format(
        title=title, nv=v, nf=f, nfm1=max(0, f - 1), fps=int(fps),
        tw=tw, th=th,
        pos_b64=base64.b64encode(frames.tobytes()).decode(),
        idx_b64=base64.b64encode(tris.tobytes()).decode(),
        uv_b64=base64.b64encode(uvs.tobytes()).decode(),
        tex_b64=base64.b64encode(texture.tobytes()).decode(),
    )
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(html)
    return path


def export_html(path: str, frames: np.ndarray, triangles: np.ndarray,
                fps: int = 30, title: str = "softbodysim_torch rollout"):
    """Write a playable single-file WebGL viewer.

    frames    : (F, V, 3) positions per frame
    triangles : (T, 3) surface indices into V
    """
    frames = np.ascontiguousarray(np.asarray(frames, np.float32))
    tris = np.ascontiguousarray(np.asarray(triangles, np.uint32)).reshape(-1, 3)
    f, v, _ = frames.shape
    html = _HTML.format(
        title=title, nv=v, nf=f, nfm1=max(0, f - 1), fps=int(fps),
        pos_b64=base64.b64encode(frames.tobytes()).decode(),
        idx_b64=base64.b64encode(tris.tobytes()).decode(),
    )
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(html)
    return path


class AnimationRecorder:
    """Collect per-frame surface positions from one or more bodies and
    export a playable HTML (and optionally an OBJ sequence / npz).

    Bodies are (surface_triangles, get_positions) pairs; multi-body scenes
    concatenate into one draw call like the reference's single manager pass.
    """

    def __init__(self):
        self._tris: list = []
        self._getters: list = []
        self._offsets: list = []
        self._frames: list = []
        self._uvs: list = []
        self._nv = 0

    def add_body(self, triangles: np.ndarray, positions_fn, uvs=None):
        t = np.asarray(triangles, np.int64).reshape(-1, 3)
        self._tris.append(t + self._nv)
        self._getters.append(positions_fn)
        probe = np.asarray(positions_fn())
        self._uvs.append(np.asarray(uvs, np.float32).reshape(len(probe), 2)
                         if uvs is not None else None)
        self._offsets.append(self._nv)
        self._nv += len(probe)
        return self

    def capture(self):
        self._frames.append(
            np.concatenate([np.asarray(g(), np.float32)
                            for g in self._getters], axis=0))
        return self

    @property
    def num_frames(self) -> int:
        return len(self._frames)

    def export(self, path: str, fps: int = 30,
               title: str = "softbodysim_torch rollout",
               obj_dir: Optional[str] = None, texture=None) -> str:
        """Lit+textured when every body carried UVs (export_html_lit);
        flat-shaded otherwise."""
        frames = np.stack(self._frames, 0)
        tris = np.concatenate(self._tris, 0)
        if obj_dir is not None:
            import os

            from ..io.export import write_obj
            os.makedirs(obj_dir, exist_ok=True)
            for i, fr in enumerate(frames):
                write_obj(os.path.join(obj_dir, f"frame_{i:05d}.obj"),
                          fr, triangles=tris)
        if self._uvs and all(u is not None for u in self._uvs):
            uvs = np.concatenate(self._uvs, 0)
            return export_html_lit(path, frames, tris, uvs,
                                   texture=texture, fps=fps, title=title)
        return export_html(path, frames, tris, fps=fps, title=title)
