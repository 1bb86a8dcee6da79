"""Interactive 3D trajectory/point-cloud viewer as one self-contained HTML.

Copy of dpvo_tpu/viz/html_viewer.py, pointed at this package's
runtime/numpy_se3.py; the page template is dpvo_tpu's, byte for byte. The
reference ships a Pangolin OpenGL viewer with live navigation
(DPViewer/dpviewer/viewer.cpp:19-313); this delivers the interactive view
as an artifact instead: a single .html file with an embedded WebGL renderer
(no external JS, no network) showing the point cloud, per-frame camera
frusta, and the trajectory line, with orbit / pan / zoom mouse navigation
and a point-size slider. Open in any browser.

Binary payload is base64 float32/uint8 — a 100k-point map is ~2 MB.
"""
from __future__ import annotations

import base64
import json

import numpy as np


def _frustum_lines(poses_wfc, scale=0.15):
    """(N, 7) world-from-cam -> line-segment endpoints (L, 2, 3)."""
    from ..runtime import numpy_se3 as nse3
    corners = np.array([
        [0, 0, 0], [-1, -0.75, 1.5], [1, -0.75, 1.5],
        [1, 0.75, 1.5], [-1, 0.75, 1.5]], np.float32) * scale
    edges = [(0, 1), (0, 2), (0, 3), (0, 4),
             (1, 2), (2, 3), (3, 4), (4, 1)]
    segs = []
    for pose in poses_wfc:
        pts = nse3.quat_rotate(
            np.broadcast_to(pose[3:7], (5, 4)), corners) + pose[:3]
        for a, b in edges:
            segs.append([pts[a], pts[b]])
    return np.asarray(segs, np.float32)


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>dpvo_tpu viewer</title>
<style>
 html,body{margin:0;height:100%%;background:#101014;overflow:hidden;
  font:12px system-ui,sans-serif;color:#ccc}
 canvas{display:block;width:100vw;height:100vh}
 #hud{position:fixed;top:8px;left:10px;user-select:none}
 #hud input{vertical-align:middle}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">%(title)s — %(npts)d points, %(nposes)d keyframes
 &nbsp;|&nbsp; drag: orbit, shift-drag: pan, wheel: zoom
 &nbsp;|&nbsp; point size <input id="ps" type="range" min="1" max="8"
 value="2" step="0.5"></div>
<script>
const PTS = "%(pts_b64)s", CLR = "%(clr_b64)s", SEG = "%(seg_b64)s",
      TRAJ = "%(traj_b64)s";
function f32(b64){const s=atob(b64);const a=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);
 return new Float32Array(a.buffer);}
function u8(b64){const s=atob(b64);const a=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return a;}
const pts=f32(PTS), clr=u8(CLR), seg=f32(SEG), traj=f32(TRAJ);

const cv=document.getElementById('c');
const gl=cv.getContext('webgl',{antialias:true});
const VS=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;
uniform float psz;varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=psz;vc=col;}`;
const FS=`precision mediump float;varying vec3 vc;
void main(){gl_FragColor=vec4(vc,1.0);}`;
function prog(){const p=gl.createProgram();
 for(const[t,s]of[[gl.VERTEX_SHADER,VS],[gl.FRAGMENT_SHADER,FS]]){
  const sh=gl.createShader(t);gl.shaderSource(sh,s);gl.compileShader(sh);
  gl.attachShader(p,sh);}
 gl.linkProgram(p);return p;}
const pr=prog();gl.useProgram(pr);
const aP=gl.getAttribLocation(pr,'p'),aC=gl.getAttribLocation(pr,'col'),
      uM=gl.getUniformLocation(pr,'mvp'),uS=gl.getUniformLocation(pr,'psz');
function buf(data){const b=gl.createBuffer();
 gl.bindBuffer(gl.ARRAY_BUFFER,b);
 gl.bufferData(gl.ARRAY_BUFFER,data,gl.STATIC_DRAW);return b;}
const bP=buf(pts);
const clrF=new Float32Array(clr.length);
for(let i=0;i<clr.length;i++)clrF[i]=clr[i]/255;
const bC=buf(clrF);
const bS=buf(seg);
const segClr=new Float32Array(seg.length);
for(let i=0;i<segClr.length;i+=3){segClr[i]=0.3;segClr[i+1]=0.9;
 segClr[i+2]=0.4;}
const bSC=buf(segClr);
const bT=buf(traj);
const trajClr=new Float32Array(traj.length);
for(let i=0;i<trajClr.length;i+=3){trajClr[i]=1.0;trajClr[i+1]=0.75;
 trajClr[i+2]=0.2;}
const bTC=buf(trajClr);

// center & radius
let cx=0,cy=0,cz=0;const n=pts.length/3;
for(let i=0;i<pts.length;i+=3){cx+=pts[i];cy+=pts[i+1];cz+=pts[i+2];}
if(n>0){cx/=n;cy/=n;cz/=n;}
let rad=0;for(let i=0;i<pts.length;i+=3){const dx=pts[i]-cx,dy=pts[i+1]-cy,
 dz=pts[i+2]-cz;rad=Math.max(rad,Math.hypot(dx,dy,dz));}
rad=Math.max(rad,1e-3);

let yaw=0.6,pitch=0.4,dist=rad*2.5,panX=0,panY=0,psz=2;
function mat(){
 const W=cv.width,H=cv.height,asp=W/H,f=1.5;
 const cyw=Math.cos(yaw),syw=Math.sin(yaw),cp=Math.cos(pitch),
       sp=Math.sin(pitch);
 // camera position on orbit sphere around (cx,cy,cz)
 const ex=cx+dist*syw*cp,ey=cy+dist*sp,ez=cz+dist*cyw*cp;
 // look-at basis
 let fx=cx-ex,fy=cy-ey,fz=cz-ez;const fl=Math.hypot(fx,fy,fz);
 fx/=fl;fy/=fl;fz/=fl;
 // r = normalize(f x worldUp), u = r x f  (right-handed view basis)
 let rx=-fz,ry=0,rz=fx;const rl=Math.hypot(rx,ry,rz)||1;rx/=rl;rz/=rl;
 const ux=ry*fz-rz*fy,uy=rz*fx-rx*fz,uz=rx*fy-ry*fx;
 const tx=ex-rx*panX-ux*panY,ty=ey-ry*panX-uy*panY,tz=ez-rz*panX-uz*panY;
 // view = [r;u;-f] * translate(-eye')
 const zn=rad*0.01,zf=rad*40;
 const a=f/asp,b=f,c=(zf+zn)/(zn-zf),d=2*zf*zn/(zn-zf);
 const vx=-(rx*tx+ry*ty+rz*tz),vy=-(ux*tx+uy*ty+uz*tz),
       vz=(fx*tx+fy*ty+fz*tz);
 // columns of P*V (GL clip: z=c*eye.z+d, w=-eye.z; eye.z=-f.(p-e))
 return new Float32Array([
  a*rx, b*ux, -c*fx, fx,
  a*ry, b*uy, -c*fy, fy,
  a*rz, b*uz, -c*fz, fz,
  a*vx, b*vy, c*vz+d, -vz]);
}
function draw(){
 cv.width=innerWidth;cv.height=innerHeight;
 gl.viewport(0,0,cv.width,cv.height);
 gl.clearColor(0.063,0.063,0.078,1);gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.uniformMatrix4fv(uM,false,mat());gl.uniform1f(uS,psz);
 gl.enableVertexAttribArray(aP);gl.enableVertexAttribArray(aC);
 gl.bindBuffer(gl.ARRAY_BUFFER,bP);
 gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,bC);
 gl.vertexAttribPointer(aC,3,gl.FLOAT,false,0,0);
 gl.drawArrays(gl.POINTS,0,pts.length/3);
 gl.bindBuffer(gl.ARRAY_BUFFER,bS);
 gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,bSC);
 gl.vertexAttribPointer(aC,3,gl.FLOAT,false,0,0);
 gl.drawArrays(gl.LINES,0,seg.length/3);
 gl.bindBuffer(gl.ARRAY_BUFFER,bT);
 gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,bTC);
 gl.vertexAttribPointer(aC,3,gl.FLOAT,false,0,0);
 gl.drawArrays(gl.LINE_STRIP,0,traj.length/3);
}
let drag=false,lx=0,ly=0,shift=false;
cv.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;shift=e.shiftKey;};
onmouseup=()=>drag=false;
onmousemove=e=>{if(!drag)return;
 const dx=e.clientX-lx,dy=e.clientY-ly;lx=e.clientX;ly=e.clientY;
 if(shift){panX+=dx*dist*0.001;panY-=dy*dist*0.001;}
 else{yaw-=dx*0.008;pitch=Math.min(1.5,Math.max(-1.5,pitch+dy*0.008));}
 draw();};
cv.onwheel=e=>{e.preventDefault();dist*=Math.exp(e.deltaY*0.001);draw();};
document.getElementById('ps').oninput=e=>{psz=+e.target.value;draw();};
onresize=draw;
draw();
</script></body></html>
"""


def save_html_viewer(path, poses_wfc, points, colors, title='dpvo_torch'):
    """Write the interactive viewer HTML.

    poses_wfc: (N, 7) world-from-camera x y z qx qy qz qw
    points:    (M, 3) float; colors: (M, 3) uint8 RGB (0-255)
    """
    poses_wfc = np.asarray(poses_wfc, np.float32).reshape(-1, 7)
    points = np.asarray(points, np.float32).reshape(-1, 3)
    colors = np.asarray(colors).reshape(-1, 3)
    if colors.dtype != np.uint8:
        colors = np.clip(colors, 0, 255).astype(np.uint8)
    # drop non-finite / absurd points (failed-depth patches)
    ok = np.isfinite(points).all(axis=1)
    med = np.median(points[ok], axis=0) if ok.any() else np.zeros(3)
    r = np.linalg.norm(points - med, axis=1)
    # median radius is robust to the far outliers being filtered (a
    # percentile near the max is not when outliers dominate the tail)
    scale = np.median(r[ok]) if ok.any() else 1.0
    ok &= r < 50 * max(scale, 1e-3)
    points, colors = points[ok], colors[: len(ok)][ok]

    segs = _frustum_lines(poses_wfc, scale=0.05 * max(scale, 1e-3))

    def b64(a):
        return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()

    html = _HTML % dict(
        title=json.dumps(title)[1:-1],
        npts=len(points), nposes=len(poses_wfc),
        pts_b64=b64(points), clr_b64=b64(colors),
        seg_b64=b64(segs.reshape(-1, 3)),
        traj_b64=b64(poses_wfc[:, :3]))
    with open(path, 'w') as f:
        f.write(html)
    return path
