"""Self-contained HTML/JS 3-D viewer page (no external dependencies).

Counterpart of diffdart_tpu/viewer/client.py, the port's own copy: a
vanilla-JS software-projected canvas renderer (orbit camera, wireframe
primitives) that either connects to GUIWebsocketServer or replays an
embedded trajectory (the reference ships a TypeScript/three.js frontend)."""

PAGE = r"""<!DOCTYPE html>
<html>
<head><meta charset="utf-8"><title>diffdart_tpu_torch viewer</title>
<style>
 body { margin:0; background:#16161e; color:#ccc; font:13px monospace; overflow:hidden }
 #hud { position:fixed; top:8px; left:10px; }
 canvas { display:block }
</style></head>
<body>
<div id="hud">diffdart_tpu_torch viewer — drag: orbit, wheel: zoom, space: pause</div>
<canvas id="c"></canvas>
<script>
"use strict";
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
let scene = null, frames = __FRAMES_JSON__, frameIdx = 0, playing = true;
let yaw = 0.8, pitch = 0.45, dist = 4.0, target=[0,0,0.4];

function resize(){ canvas.width = innerWidth; canvas.height = innerHeight; }
addEventListener('resize', resize); resize();

let dragging=false, px=0, py=0;
let sock = null;            // live websocket (set below when streaming)
let pickBody = -1;          // body grabbed with shift+drag
function pickAt(x, y){      // nearest projected geom center -> its body
  if(!scene || !frames.length) return -1;
  const f = frames[Math.min(frameIdx, frames.length-1)];
  let best = -1, bd = 40*40;  // 40 px pick radius
  for(let i=0;i<scene.geoms.length;i++){
    if(scene.geoms[i].body < 0) continue;
    const P = project(f.poses[i].pos); if(!P) continue;
    const d = (P[0]-x)*(P[0]-x) + (P[1]-y)*(P[1]-y);
    if(d < bd){ bd = d; best = scene.geoms[i].body; }
  }
  return best;
}
canvas.addEventListener('mousedown', e=>{
  if(e.shiftKey && sock){ pickBody = pickAt(e.x, e.y); }
  else { dragging=true; }
  px=e.x; py=e.y;
});
addEventListener('mouseup', ()=>{ dragging=false; pickBody=-1; });
addEventListener('mousemove', e=>{
  if(pickBody >= 0 && sock && sock.readyState === 1){
    // screen-space drag -> world force in the camera plane (x right, z up)
    const s = 2.0;  // N per pixel
    const dx = (e.x-px)*s, dz = -(e.y-py)*s;
    const fx = dx*Math.cos(yaw), fy = -dx*Math.sin(yaw);
    sock.send(JSON.stringify({type:'drag', body:pickBody, force:[fx,fy,dz]}));
    px=e.x; py=e.y;
  } else if(dragging){ yaw+=(e.x-px)*0.008; pitch=Math.max(-1.5,Math.min(1.5,pitch+(e.y-py)*0.008)); px=e.x; py=e.y; }
});
canvas.addEventListener('wheel', e=>{ dist*=Math.exp(e.deltaY*0.001); });
addEventListener('keydown', e=>{
  if(e.key===' ') playing=!playing;
  if(sock && sock.readyState === 1) sock.send(JSON.stringify({type:'key', key:e.key}));
});

function quatRot(q, v){ // q = [w,x,y,z]
  const [w,x,y,z]=q, [vx,vy,vz]=v;
  const tx=2*(y*vz-z*vy), ty=2*(z*vx-x*vz), tz=2*(x*vy-y*vx);
  return [vx+w*tx+(y*tz-z*ty), vy+w*ty+(z*tx-x*tz), vz+w*tz+(x*ty-y*tx)];
}
function project(p){
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  let x=p[0]-target[0], y=p[1]-target[1], z=p[2]-target[2];
  let x1= cy*x+sy*y, y1=-sy*x+cy*y;             // yaw about z
  let y2= cp*y1+sp*z, z2=-sp*y1+cp*z;           // pitch
  const d = dist + y2;
  if (d < 0.05) return null;
  const f = Math.min(canvas.width, canvas.height)*0.9/d;
  return [canvas.width/2 + x1*f, canvas.height/2 - z2*f];
}
function line(a,b,color){ const A=project(a), B=project(b); if(!A||!B)return;
  ctx.strokeStyle=color; ctx.beginPath(); ctx.moveTo(A[0],A[1]); ctx.lineTo(B[0],B[1]); ctx.stroke(); }

function boxEdges(s){ const [hx,hy,hz]=s; const c=[];
  for(const sx of[-1,1])for(const sy of[-1,1])for(const sz of[-1,1]) c.push([sx*hx,sy*hy,sz*hz]);
  const E=[[0,1],[2,3],[4,5],[6,7],[0,2],[1,3],[4,6],[5,7],[0,4],[1,5],[2,6],[3,7]];
  return {verts:c, edges:E}; }
function circlePts(r, n, axis, off){ const pts=[];
  for(let i=0;i<=n;i++){ const a=2*Math.PI*i/n;
    if(axis==2) pts.push([r*Math.cos(a), r*Math.sin(a), off]);
    else if(axis==0) pts.push([off, r*Math.cos(a), r*Math.sin(a)]);
    else pts.push([r*Math.cos(a), off, r*Math.sin(a)]); }
  return pts; }

function drawGeom(g, pose){
  const col = g.color, T = v => { const r=quatRot(pose.quat, v); return [r[0]+pose.pos[0], r[1]+pose.pos[1], r[2]+pose.pos[2]]; };
  if(g.type==='plane'){
    ctx.strokeStyle='#333a45';
    for(let i=-5;i<=5;i++){ line(T([i,-5,0]),T([i,5,0]),'#2c333d'); line(T([-5,i,0]),T([5,i,0]),'#2c333d'); }
    return;
  }
  if(g.type==='box'){ const {verts,edges}=boxEdges(g.size);
    for(const [i,j] of edges) line(T(verts[i]), T(verts[j]), col); return; }
  if(g.type==='sphere'||g.type==='ellipsoid'){ const r=g.size[0];
    for(const ax of [0,1,2]){ const pts=circlePts(r,20,ax,0);
      for(let i=0;i<pts.length-1;i++) line(T(pts[i]),T(pts[i+1]),col); } return; }
  if(g.type==='capsule'||g.type==='cylinder'){ const r=g.size[0], h=g.size[1];
    for(const off of [-h, h]){ const pts=circlePts(r,16,2,off);
      for(let i=0;i<pts.length-1;i++) line(T(pts[i]),T(pts[i+1]),col); }
    for(const a of [0, Math.PI/2, Math.PI, 3*Math.PI/2]){
      const x=r*Math.cos(a), y=r*Math.sin(a);
      line(T([x,y,-h]), T([x,y,h]), col); }
    return; }
  if(g.type==='convex' && g.verts){
    // wireframe: connect each hull vertex to its 3 nearest neighbours
    const V = g.verts;
    for(let i=0;i<V.length;i++){
      const ds = V.map((v,j)=>[ (v[0]-V[i][0])**2+(v[1]-V[i][1])**2+(v[2]-V[i][2])**2, j ])
                  .sort((a,b)=>a[0]-b[0]);
      for(let k=1;k<=3 && k<ds.length;k++) line(T(V[i]), T(V[ds[k][1]]), col);
    }
    return; }
}

function render(){
  ctx.fillStyle='#16161e'; ctx.fillRect(0,0,canvas.width,canvas.height);
  // axes
  line([0,0,0],[0.3,0,0],'#e45756'); line([0,0,0],[0,0.3,0],'#54a24b'); line([0,0,0],[0,0,0.3],'#4c78a8');
  if(scene && ghost && ghost.length){   // optimizer iterate, ghost-rendered
    ctx.globalAlpha = 0.35;
    const gf = ghost[ghostIdx % ghost.length];
    for(let i=0;i<scene.geoms.length;i++) drawGeom(scene.geoms[i], gf[i]);
    ctx.globalAlpha = 1.0;
    if(playing) ghostIdx++;
  }
  if(scene && frames.length){
    const f = frames[Math.min(frameIdx, frames.length-1)];
    for(let i=0;i<scene.geoms.length;i++) drawGeom(scene.geoms[i], f.poses[i]);
    ctx.fillStyle='#888'; ctx.fillText(`t=${f.t.toFixed(3)}s  frame ${frameIdx}/${frames.length-1}`, 10, canvas.height-12);
    if(playing){ frameIdx = (frameIdx+1) % frames.length; }
  }
  requestAnimationFrame(render);
}

const embeddedScene = __SCENE_JSON__;
if (embeddedScene) { scene = embeddedScene; }
const wsUrl = __WS_URL__;
let ghost = null;  // mid-optimization trajectory (poses list per frame)
let ghostIdx = 0;
if (!scene && 'WebSocket' in window && wsUrl) {
  sock = new WebSocket(wsUrl);
  sock.onmessage = ev => {
    const msg = JSON.parse(ev.data);
    if(msg.kind==='scene') { scene = msg; frames = []; }
    else if(msg.kind==='frame') { frames.push(msg); if(frames.length>2000) frames.shift(); frameIdx=frames.length-1; }
    else if(msg.kind==='trajectory') { ghost = msg.frames; ghostIdx = 0; }
  };
}
render();
</script>
</body></html>
"""


def build_page(scene_json="null", frames_json="[]", ws_url="null"):
    return (
        PAGE.replace("__SCENE_JSON__", scene_json)
        .replace("__FRAMES_JSON__", frames_json)
        .replace("__WS_URL__", ws_url)
    )
