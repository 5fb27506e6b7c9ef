"""Self-contained HTML model viewer export.

Port of colmap_tpu/tools/html_viewer.py, a host copy whose files are
byte-equal to the JAX package's. The reference ships an OpenGL model
viewer (src/colmap/ui/model_viewer_widget.h:50) inside its Qt GUI; a
headless machine gets a single .html file instead: point cloud and camera
frusta rendered with embedded vanilla WebGL (no external scripts) and
orbit / pan / zoom mouse controls. `convert_model(..., "HTML")` routes
here (reference converter: exe/model.cc:583). The page's title keeps the
JAX package's text, so that both write the same bytes.
"""

from __future__ import annotations

import base64

import numpy as np

from colmap_tpu_torch.scene.reconstruction import Reconstruction


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def _frustum_segments(rec: Reconstruction, scale: float) -> np.ndarray:
    """Line-segment soup (K, 3) f32: 8 segments per registered camera
    (4 sides of the image-plane pyramid + the image-plane rectangle)."""
    segs = []
    for img in rec.images.values():
        if not img.registered:
            continue
        cam = rec.cameras.get(img.camera_id)
        q = img.cam_from_world[:4] / np.linalg.norm(img.cam_from_world[:4])
        w, x, y, z = q
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        C = -R.T @ img.cam_from_world[4:7]
        if cam is not None and len(cam.params) >= 1 and cam.width > 0:
            f = float(cam.params[0])
            hw = 0.5 * cam.width / f
            hh = 0.5 * cam.height / f
        else:
            hw = hh = 0.4
        corners_cam = np.array([
            [-hw, -hh, 1.0], [hw, -hh, 1.0], [hw, hh, 1.0], [-hw, hh, 1.0],
        ]) * scale
        corners = (R.T @ corners_cam.T).T + C
        for k in range(4):
            segs.append(C)
            segs.append(corners[k])
            segs.append(corners[k])
            segs.append(corners[(k + 1) % 4])
    if not segs:
        return np.zeros((0, 3), np.float32)
    return np.asarray(segs, np.float32)


def write_html(rec: Reconstruction, path: str, max_points: int = 2_000_000):
    """Write the reconstruction as one self-contained interactive HTML."""
    pids = list(rec.points3D.keys())[:max_points]
    if pids:
        xyz = np.stack([rec.points3D[p].xyz for p in pids]).astype(np.float32)
        rgb = np.stack([rec.points3D[p].color for p in pids]).astype(np.uint8)
    else:
        xyz = np.zeros((0, 3), np.float32)
        rgb = np.zeros((0, 3), np.uint8)

    center = xyz.mean(axis=0) if len(xyz) else np.zeros(3, np.float32)
    spread = float(np.percentile(np.linalg.norm(xyz - center, axis=1), 90)) \
        if len(xyz) else 1.0
    spread = max(spread, 1e-6)
    frusta = _frustum_segments(rec, scale=0.15 * spread)

    n_img = rec.num_registered_images()
    html = _TEMPLATE.replace("__POINTS_B64__", _b64(xyz)) \
        .replace("__COLORS_B64__", _b64(rgb)) \
        .replace("__FRUSTA_B64__", _b64(frusta)) \
        .replace("__CENTER__", f"[{center[0]},{center[1]},{center[2]}]") \
        .replace("__SPREAD__", f"{spread}") \
        .replace("__TITLE__",
                 f"colmap_tpu model — {len(xyz)} points, {n_img} cameras")
    with open(path, "w") as fp:
        fp.write(html)


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#111;font:12px sans-serif}
 #hud{position:fixed;left:8px;top:8px;color:#ccc;user-select:none}
 canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<div id="hud">__TITLE__ &mdash; drag: orbit &middot; shift-drag: pan &middot; wheel: zoom</div>
<canvas id="c"></canvas>
<script>
"use strict";
function decode(b64, T){const s=atob(b64);const u=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)u[i]=s.charCodeAt(i);return new T(u.buffer);}
const pts=decode("__POINTS_B64__",Float32Array);
const cols=decode("__COLORS_B64__",Uint8Array);
const fr=decode("__FRUSTA_B64__",Float32Array);
const center=__CENTER__, spread=__SPREAD__;
const canvas=document.getElementById("c");
const gl=canvas.getContext("webgl");
const VS=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;uniform float ps;
 varying vec3 vc;void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=ps;vc=col;}`;
const FS=`precision mediump float;varying vec3 vc;void main(){gl_FragColor=vec4(vc,1.0);}`;
function prog(){const p=gl.createProgram();
 for(const[t,src]of[[gl.VERTEX_SHADER,VS],[gl.FRAGMENT_SHADER,FS]]){
  const s=gl.createShader(t);gl.shaderSource(s,src);gl.compileShader(s);gl.attachShader(p,s);}
 gl.linkProgram(p);return p;}
const P=prog();gl.useProgram(P);
const locP=gl.getAttribLocation(P,"p"),locC=gl.getAttribLocation(P,"col");
const locMVP=gl.getUniformLocation(P,"mvp"),locPS=gl.getUniformLocation(P,"ps");
function buf(data){const b=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b);
 gl.bufferData(gl.ARRAY_BUFFER,data,gl.STATIC_DRAW);return b;}
const bP=buf(pts),bF=buf(fr);
const colsF=new Float32Array(cols.length);for(let i=0;i<cols.length;i++)colsF[i]=cols[i]/255;
const bC=buf(colsF);
const frCol=new Float32Array(fr.length);for(let i=0;i<fr.length;i+=3){frCol[i]=1;frCol[i+1]=0.35;frCol[i+2]=0.1;}
const bFC=buf(frCol);
// mat4 helpers (column-major)
function mul(a,b){const o=new Float32Array(16);
 for(let c=0;c<4;c++)for(let r=0;r<4;r++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+r]*b[c*4+k];o[c*4+r]=s;}return o;}
function persp(fovy,asp,n,f){const t=1/Math.tan(fovy/2);const o=new Float32Array(16);
 o[0]=t/asp;o[5]=t;o[10]=(f+n)/(n-f);o[11]=-1;o[14]=2*f*n/(n-f);return o;}
function lookAt(eye,ctr,up){const z=norm3(sub3(eye,ctr)),x=norm3(cross3(up,z)),y=cross3(z,x);
 const o=new Float32Array(16);o[0]=x[0];o[4]=x[1];o[8]=x[2];o[1]=y[0];o[5]=y[1];o[9]=y[2];
 o[2]=z[0];o[6]=z[1];o[10]=z[2];o[12]=-dot3(x,eye);o[13]=-dot3(y,eye);o[14]=-dot3(z,eye);o[15]=1;return o;}
function sub3(a,b){return[a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function cross3(a,b){return[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;return[a[0]/l,a[1]/l,a[2]/l];}
let az=0.6,el=0.4,dist=3*spread,tgt=center.slice();
let drag=null;
canvas.addEventListener("mousedown",e=>{drag={x:e.clientX,y:e.clientY,pan:e.shiftKey};});
window.addEventListener("mouseup",()=>drag=null);
window.addEventListener("mousemove",e=>{if(!drag)return;
 const dx=e.clientX-drag.x,dy=e.clientY-drag.y;drag.x=e.clientX;drag.y=e.clientY;
 if(drag.pan){const s=dist*0.0015;
  const fwd=[Math.cos(el)*Math.sin(az),Math.sin(el),Math.cos(el)*Math.cos(az)];
  const right=norm3(cross3(fwd,[0,1,0])),up=cross3(right,fwd);
  for(let i=0;i<3;i++)tgt[i]+=(-dx*right[i]+dy*up[i])*s;}
 else{az-=dx*0.006;el=Math.max(-1.5,Math.min(1.5,el+dy*0.006));}
 draw();});
canvas.addEventListener("wheel",e=>{e.preventDefault();
 dist*=Math.exp(e.deltaY*0.001);dist=Math.max(0.05*spread,Math.min(50*spread,dist));draw();},{passive:false});
function draw(){
 const w=canvas.clientWidth,h=canvas.clientHeight;
 if(canvas.width!==w||canvas.height!==h){canvas.width=w;canvas.height=h;}
 gl.viewport(0,0,w,h);gl.clearColor(0.07,0.07,0.08,1);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);gl.enable(gl.DEPTH_TEST);
 const eye=[tgt[0]+dist*Math.cos(el)*Math.sin(az),tgt[1]+dist*Math.sin(el),
            tgt[2]+dist*Math.cos(el)*Math.cos(az)];
 const mvp=mul(persp(0.9,w/h,0.01*spread,100*spread),lookAt(eye,tgt,[0,1,0]));
 gl.uniformMatrix4fv(locMVP,false,mvp);
 gl.enableVertexAttribArray(locP);gl.enableVertexAttribArray(locC);
 gl.uniform1f(locPS,2.0);
 gl.bindBuffer(gl.ARRAY_BUFFER,bP);gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,bC);gl.vertexAttribPointer(locC,3,gl.FLOAT,false,0,0);
 gl.drawArrays(gl.POINTS,0,pts.length/3);
 gl.bindBuffer(gl.ARRAY_BUFFER,bF);gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,bFC);gl.vertexAttribPointer(locC,3,gl.FLOAT,false,0,0);
 gl.drawArrays(gl.LINES,0,fr.length/3);
}
window.addEventListener("resize",draw);
draw();
</script></body></html>
"""
