"""Browser app: the reference Gradio UI rebuilt as a dependency-free SPA
(port of ``recondet3d/serve/webapp.py``: the same routes and page; the
3DGS novel-view video renders on the manager's device).

Feature parity with the reference app (reference: app/gradio_app.py:1-724 +
app/modules/{ui_components,event_handlers,file_handlers,visualization,
model_inference}.py, ~2800 LoC of gradio wiring):

- multi-image or video upload (server-side frame extraction at a chosen
  time interval — file_handlers.py video path)
- "Point Cloud & Cameras" tab: WebGL point-cloud viewer (orbit/pan/zoom)
  with camera-frustum wireframes, confidence-percentile filter, sky /
  black-background / white-background filters, max-point cap — the same
  knobs the gradio viewer exposes (show_cam, filter_black_bg,
  filter_white_bg, save_percentage, num_max_points)
- "Metric Depth" tab: per-view input + turbo depth with prev/next
  navigation and click-to-measure metric depth readout
- "3DGS Novel Views" tab: trajectory-mode dropdown -> server-rendered
  novel-view video (gs_trj_mode / gs_video_quality equivalents)
- gallery browsing of previous reconstructions + export downloads

gradio is not a dependency (and a server on a GPU host is headless); the
page below is a single self-contained HTML document served by the
stdlib backend — no CDN, no build step.
"""

from __future__ import annotations

import json
import os
import urllib.parse

__all__ = ["app_html", "handle_scene_get", "handle_scene_post"]


def _scene_dir(manager, tid: str):
    root = os.path.realpath(os.path.join(manager.workdir, "tasks"))
    full = os.path.realpath(os.path.join(root, tid))
    if not full.startswith(root + os.sep) and full != root:
        return None
    return full if os.path.isdir(full) else None


def handle_scene_get(manager, path: str):
    """Route GET /scene/<tid>/... -> (bytes, content_type, status)."""
    from recondet3d_torch.serve import scene_store as ss

    parsed = urllib.parse.urlparse(path)
    parts = parsed.path.split("/")
    if len(parts) < 4:
        return b'{"error": "bad path"}', "application/json", 400
    tid, rest = parts[2], "/".join(parts[3:])
    q = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
    d = _scene_dir(manager, tid)
    scene = ss.load_scene(d) if d else None
    if scene is None:
        return b'{"error": "no scene"}', "application/json", 404

    if rest == "meta":
        meta = ss.scene_meta(scene)
        meta["frusta"] = ss.camera_frusta(scene)
        return json.dumps(meta).encode(), "application/json", 200
    if rest == "points.bin":
        body = ss.scene_points_bin(
            scene,
            max_points=int(q.get("max", 300000)),
            conf_percent=float(q.get("conf", 30)),
            filter_sky=q.get("sky", "1") != "0",
            filter_black_bg=q.get("black", "0") == "1",
            filter_white_bg=q.get("white", "0") == "1",
        )
        return body, "application/octet-stream", 200
    if rest == "measure":
        out = ss.measure(scene, int(q.get("view", 0)),
                         float(q.get("u", 0.5)), float(q.get("v", 0.5)))
        return json.dumps(out).encode(), "application/json", 200
    if rest.startswith("depth/") and rest.endswith(".png"):
        view = int(rest[len("depth/"):-len(".png")])
        return ss.depth_png(scene, view), "image/png", 200
    if rest.startswith("image/") and rest.endswith(".jpg"):
        view = int(rest[len("image/"):-len(".jpg")])
        body = ss.image_jpg(scene, view)
        return (body, "image/jpeg", 200) if body else \
            (b'{"error": "no images"}', "application/json", 404)
    return b'{"error": "not found"}', "application/json", 404


def handle_scene_post(manager, path: str, payload: dict):
    """Route POST /scene/<tid>/gs_video -> renders novel views to mp4 on
    ``manager.device``."""
    import numpy as np

    from recondet3d_torch.serve import scene_store as ss

    parts = path.split("/")
    if len(parts) < 4 or parts[3] != "gs_video":
        return b'{"error": "not found"}', "application/json", 404
    tid = parts[2]
    d = _scene_dir(manager, tid)
    scene = ss.load_scene(d) if d else None
    if scene is None or "gs_means" not in scene:
        return (b'{"error": "scene has no gaussians (run with infer_gs)"}',
                "application/json", 400)

    from recondet3d_torch.data.export import export_to_gs_video
    from recondet3d_torch.specs import Gaussians, Prediction
    from recondet3d_torch.utils import camera_traj as ct

    pred = Prediction(
        depth=scene["depth"], extrinsics=scene["extrinsics"],
        intrinsics=scene["intrinsics"],
        gaussians=Gaussians(
            means=scene["gs_means"], scales=scene["gs_scales"],
            rotations=scene["gs_rotations"], harmonics=scene["gs_harmonics"],
            opacities=scene["gs_opacities"],
        ),
    )
    mode = payload.get("traj", "interpolate")
    n_frames = int(payload.get("frames", 24))
    quality = payload.get("quality", "fast")
    hw = scene["depth"].shape[-2:]
    if quality == "fast":  # half-res render, the gradio "fast" preset
        hw = (hw[0] // 2, hw[1] // 2)
    exts = ixts = None
    if mode in ("wander", "wobble", "dolly_zoom"):
        fn = {"wander": ct.wander_path, "wobble": ct.wobble_path,
              "dolly_zoom": ct.dolly_zoom_path}[mode]
        exts, ixts = fn(np.asarray(scene["extrinsics"][0]),
                        np.asarray(scene["intrinsics"][0]), n_frames=n_frames)
    path_out = export_to_gs_video(pred, d, render_hw=hw, render_exts=exts,
                                  render_ixts=ixts, device=manager.device)
    return (json.dumps({"file": f"/files/{tid}/{os.path.basename(path_out)}"})
            .encode(), "application/json", 200)


def app_html() -> str:
    return _APP_HTML


_APP_HTML = r"""<!doctype html><html><head><meta charset="utf-8">
<title>recondet3d — 3D reconstruction</title><style>
:root{--bg:#14161a;--panel:#1e2128;--fg:#d8dce3;--acc:#4da3ff;--mut:#8a91a0}
*{box-sizing:border-box}body{margin:0;font:14px/1.45 system-ui,sans-serif;
background:var(--bg);color:var(--fg);display:flex;height:100vh}
#side{width:320px;min-width:320px;overflow-y:auto;background:var(--panel);
padding:14px;border-right:1px solid #000}
#main{flex:1;display:flex;flex-direction:column;min-width:0}
h2{margin:2px 0 10px;font-size:17px}h3{margin:14px 0 6px;font-size:13px;
color:var(--mut);text-transform:uppercase;letter-spacing:.06em}
label{display:block;margin:7px 0 2px;color:var(--mut);font-size:12px}
input[type=file],select{width:100%;background:#12141a;color:var(--fg);
border:1px solid #333;border-radius:4px;padding:5px}
input[type=range]{width:100%}
button{background:var(--acc);border:0;color:#fff;padding:8px 14px;
border-radius:5px;cursor:pointer;font-size:14px}
button:disabled{background:#555;cursor:default}
button.sec{background:#343945}
#tabs{display:flex;background:var(--panel);border-bottom:1px solid #000}
#tabs div{padding:9px 18px;cursor:pointer;color:var(--mut)}
#tabs div.on{color:var(--fg);border-bottom:2px solid var(--acc)}
.pane{flex:1;display:none;position:relative;min-height:0;overflow:auto}
.pane.on{display:block}
#gl{width:100%;height:100%;display:block;touch-action:none}
#status{margin:8px 0;font-size:12px;color:var(--acc);min-height:16px;
white-space:pre-wrap}
.chk{display:flex;align-items:center;gap:6px;margin:4px 0;font-size:13px}
.chk input{margin:0}
#gallery div{padding:5px 7px;border:1px solid #333;border-radius:4px;
margin:4px 0;cursor:pointer;font-size:12px;overflow:hidden;
text-overflow:ellipsis;white-space:nowrap}
#gallery div:hover{border-color:var(--acc)}
#depthPane{padding:16px}#depthPane img{max-width:46%;border:1px solid #333;
border-radius:4px;cursor:crosshair}
#measureOut{font-size:15px;margin:10px 0;color:var(--acc)}
#gsPane,#exportPane{padding:16px}
#exportPane a{display:block;color:var(--acc);margin:4px 0}
video{max-width:90%;margin-top:12px}
.row{display:flex;gap:8px;align-items:center}
.val{color:var(--fg);font-size:12px;float:right}
</style></head><body>
<div id=side>
<h2>recondet3d</h2>
<h3>Input</h3>
<label>Images (multi-select)</label>
<input type=file id=imgs multiple accept="image/*">
<label>or Video</label>
<input type=file id=vid accept="video/*">
<label>Frame interval (s) <span class=val id=tiv>1.0</span></label>
<input type=range id=tint min=0.2 max=5 step=0.2 value=1
 oninput="tiv.textContent=this.value">
<h3>Reconstruction</h3>
<label>Reference view strategy</label>
<select id=refstrat><option>saddle_balanced</option><option>first</option>
<option>middle</option><option>saddle_sim_range</option></select>
<div class=chk><input type=checkbox id=infergs><label for=infergs
 style=margin:0>3D Gaussians (enables novel views)</label></div>
<label>Export format</label>
<select id=fmt><option>glb</option><option>depth_vis</option>
<option>mini_npz</option><option>npz</option><option>gs_ply</option>
<option>colmap</option></select>
<button id=run style="margin-top:10px;width:100%">Reconstruct</button>
<div id=status></div>
<h3>View filters</h3>
<label>Max points <span class=val id=mpv>300k</span></label>
<input type=range id=maxpts min=4 max=20 step=1 value=12
 oninput="mpv.textContent=(25*Math.pow(2,this.value/2)|0)+'k'">
<label>Confidence percentile <span class=val id=cpv>30</span></label>
<input type=range id=confp min=0 max=90 step=5 value=30
 oninput="cpv.textContent=this.value">
<div class=chk><input type=checkbox id=showcam checked><label for=showcam
 style=margin:0>Show cameras</label></div>
<div class=chk><input type=checkbox id=fsky checked><label for=fsky
 style=margin:0>Filter sky</label></div>
<div class=chk><input type=checkbox id=fblack><label for=fblack
 style=margin:0>Filter black background</label></div>
<div class=chk><input type=checkbox id=fwhite><label for=fwhite
 style=margin:0>Filter white background</label></div>
<button id=refresh class=sec style="margin-top:6px">Apply filters</button>
<h3>Gallery</h3>
<div id=gallery></div>
</div>
<div id=main>
<div id=tabs>
<div class=on data-p=viewPane>Point Cloud &amp; Cameras</div>
<div data-p=depthPane>Metric Depth</div>
<div data-p=gsPane>3DGS Novel Views</div>
<div data-p=exportPane>Exports</div>
</div>
<div class="pane on" id=viewPane><canvas id=gl></canvas></div>
<div class=pane id=depthPane>
<div class=row><button id=prevv class=sec>&#8592; prev</button>
<select id=viewsel></select>
<button id=nextv class=sec>next &#8594;</button></div>
<div id=measureOut>click the depth map to measure</div>
<div><img id=imgview alt=""> <img id=depthview alt=""></div>
</div>
<div class=pane id=gsPane>
<div class=row><label style=margin:0>Trajectory</label>
<select id=trj><option>interpolate</option><option>wander</option>
<option>wobble</option><option>dolly_zoom</option></select>
<select id=gsq><option>fast</option><option>full</option></select>
<button id=rendergs>Render novel views</button></div>
<div id=gsstatus></div><video id=gsvid controls></video>
</div>
<div class=pane id=exportPane><h3>Export artifacts</h3><div id=exports></div>
</div>
</div>
<script>
"use strict";
let SCENE = null, META = null;

/* ---------- tabs ---------- */
for (const t of document.querySelectorAll('#tabs div')) t.onclick = () => {
  document.querySelectorAll('#tabs div').forEach(x => x.classList.remove('on'));
  document.querySelectorAll('.pane').forEach(x => x.classList.remove('on'));
  t.classList.add('on');
  document.getElementById(t.dataset.p).classList.add('on');
  if (t.dataset.p === 'viewPane') resize();
};

/* ---------- WebGL point viewer ---------- */
const canvas = document.getElementById('gl');
const gl = canvas.getContext('webgl', {antialias: true});
const VS = `attribute vec3 p;attribute vec3 c;uniform mat4 mvp;
uniform float ps;varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.);gl_PointSize=ps;vc=c;}`;
const FS = `precision mediump float;varying vec3 vc;
void main(){gl_FragColor=vec4(vc,1.);}`;
function mkProg(vs, fs){
  const p = gl.createProgram();
  for (const [t, src] of [[gl.VERTEX_SHADER, vs], [gl.FRAGMENT_SHADER, fs]]) {
    const s = gl.createShader(t); gl.shaderSource(s, src); gl.compileShader(s);
    gl.attachShader(p, s);
  }
  gl.linkProgram(p); return p;
}
const prog = mkProg(VS, FS);
const aP = gl.getAttribLocation(prog, 'p'), aC = gl.getAttribLocation(prog, 'c');
const uMVP = gl.getUniformLocation(prog, 'mvp'), uPS = gl.getUniformLocation(prog, 'ps');
let buf = gl.createBuffer(), nPts = 0;
let lineBuf = gl.createBuffer(), nLines = 0;
let center = [0, 0, 0], radius = 5;
let theta = -0.9, phi = 0.5, dist = 3, panX = 0, panY = 0;

function matMul(a, b){ const o = new Float32Array(16);
  for (let i = 0; i < 4; i++) for (let j = 0; j < 4; j++){
    let s = 0; for (let k = 0; k < 4; k++) s += a[k*4+j]*b[i*4+k]; o[i*4+j]=s;}
  return o; }
function persp(fov, asp, n, f){ const t = 1/Math.tan(fov/2);
  return new Float32Array([t/asp,0,0,0, 0,t,0,0, 0,0,(f+n)/(n-f),-1,
    0,0,2*f*n/(n-f),0]); }
function lookAt(eye, ctr, up){
  const sub=(a,b)=>[a[0]-b[0],a[1]-b[1],a[2]-b[2]];
  const nrm=v=>{const l=Math.hypot(...v)||1;return v.map(x=>x/l);};
  const cross=(a,b)=>[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];
  const z=nrm(sub(eye,ctr)), x=nrm(cross(up,z)), y=cross(z,x);
  const d=v=>-(v[0]*eye[0]+v[1]*eye[1]+v[2]*eye[2]);
  return new Float32Array([x[0],y[0],z[0],0, x[1],y[1],z[1],0,
    x[2],y[2],z[2],0, d(x),d(y),d(z),1]); }

function draw(){
  const w = canvas.clientWidth, h = canvas.clientHeight;
  gl.viewport(0, 0, canvas.width, canvas.height);
  gl.clearColor(0.08, 0.09, 0.11, 1);
  gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  if (!nPts && !nLines) return;
  const eye = [
    center[0] + panX + dist*radius*Math.cos(phi)*Math.cos(theta),
    center[1] + panY - dist*radius*Math.sin(phi),
    center[2] + dist*radius*Math.cos(phi)*Math.sin(theta)];
  const ctr = [center[0]+panX, center[1]+panY, center[2]];
  const mvp = matMul(persp(0.9, w/h, 0.01*radius, 100*radius),
                     lookAt(eye, ctr, [0, -1, 0]));
  gl.useProgram(prog);
  gl.uniformMatrix4fv(uMVP, false, mvp);
  gl.bindBuffer(gl.ARRAY_BUFFER, buf);
  gl.enableVertexAttribArray(aP); gl.enableVertexAttribArray(aC);
  gl.vertexAttribPointer(aP, 3, gl.FLOAT, false, 24, 0);
  gl.vertexAttribPointer(aC, 3, gl.FLOAT, false, 24, 12);
  gl.uniform1f(uPS, 2.0);
  gl.drawArrays(gl.POINTS, 0, nPts);
  if (nLines && document.getElementById('showcam').checked) {
    gl.bindBuffer(gl.ARRAY_BUFFER, lineBuf);
    gl.vertexAttribPointer(aP, 3, gl.FLOAT, false, 24, 0);
    gl.vertexAttribPointer(aC, 3, gl.FLOAT, false, 24, 12);
    gl.drawArrays(gl.LINES, 0, nLines);
  }
}
function resize(){
  canvas.width = canvas.clientWidth * devicePixelRatio;
  canvas.height = canvas.clientHeight * devicePixelRatio;
  draw();
}
window.onresize = resize;
let drag = null;
canvas.onpointerdown = e => { drag = [e.clientX, e.clientY, e.button]; };
window.onpointerup = () => drag = null;
window.onpointermove = e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2] === 2 || e.shiftKey) { panX -= dx*0.002*radius*dist; panY -= dy*0.002*radius*dist; }
  else { theta += dx*0.008; phi = Math.max(-1.5, Math.min(1.5, phi + dy*0.008)); }
  drag = [e.clientX, e.clientY, drag[2]];
  draw();
};
canvas.oncontextmenu = e => e.preventDefault();
canvas.onwheel = e => { e.preventDefault();
  dist = Math.max(0.05, dist * Math.exp(e.deltaY * 0.001)); draw(); };

async function loadPoints(){
  if (!SCENE) return;
  const mp = (25 * Math.pow(2, +document.getElementById('maxpts').value/2) | 0) * 1000;
  const q = new URLSearchParams({
    max: mp, conf: document.getElementById('confp').value,
    sky: document.getElementById('fsky').checked ? 1 : 0,
    black: document.getElementById('fblack').checked ? 1 : 0,
    white: document.getElementById('fwhite').checked ? 1 : 0});
  const r = await fetch(`/scene/${SCENE}/points.bin?` + q);
  const arr = new Float32Array(await r.arrayBuffer());
  nPts = arr.length / 6;
  let mn = [1e9,1e9,1e9], mx = [-1e9,-1e9,-1e9];
  for (let i = 0; i < nPts; i++) for (let k = 0; k < 3; k++){
    const v = arr[i*6+k];
    if (v < mn[k]) mn[k] = v; if (v > mx[k]) mx[k] = v; }
  center = [(mn[0]+mx[0])/2, (mn[1]+mx[1])/2, (mn[2]+mx[2])/2];
  radius = Math.max(0.5, Math.hypot(mx[0]-mn[0], mx[1]-mn[1], mx[2]-mn[2])/2);
  gl.bindBuffer(gl.ARRAY_BUFFER, buf);
  gl.bufferData(gl.ARRAY_BUFFER, arr, gl.STATIC_DRAW);
  // frusta lines (cyan)
  const segs = [];
  for (const cam of (META.frusta || []))
    for (const [a, b] of cam) segs.push(...a, 0.2, 0.9, 1.0, ...b, 0.2, 0.9, 1.0);
  nLines = segs.length / 6;
  gl.bindBuffer(gl.ARRAY_BUFFER, lineBuf);
  gl.bufferData(gl.ARRAY_BUFFER, new Float32Array(segs), gl.STATIC_DRAW);
  resize();
}
document.getElementById('refresh').onclick = loadPoints;
document.getElementById('showcam').onchange = draw;

/* ---------- upload + run ---------- */
const status = document.getElementById('status');
document.getElementById('run').onclick = async () => {
  const fd = new FormData();
  const imgs = document.getElementById('imgs').files;
  const vid = document.getElementById('vid').files;
  if (!imgs.length && !vid.length) { status.textContent = 'select images or a video'; return; }
  for (const f of imgs) fd.append('images', f);
  if (vid.length) fd.append('video', vid[0]);
  fd.append('s_time_interval', document.getElementById('tint').value);
  fd.append('export_format', document.getElementById('fmt').value);
  fd.append('ref_view_strategy', document.getElementById('refstrat').value);
  fd.append('infer_gs', document.getElementById('infergs').checked ? '1' : '0');
  status.textContent = 'uploading...';
  const j = await (await fetch('/upload', {method: 'POST', body: fd})).json();
  if (!j.task_id) { status.textContent = 'error: ' + JSON.stringify(j); return; }
  status.textContent = `task ${j.task_id}: queued`;
  while (true) {
    const s = await (await fetch('/status/' + j.task_id)).json();
    status.textContent = `task ${j.task_id}: ${s.status}`;
    if (s.status === 'done') { await openScene(j.task_id); break; }
    if (s.status === 'failed') { status.textContent += '\n' + (s.error||'').split('\n')[0]; break; }
    await new Promise(r => setTimeout(r, 1500));
  }
  loadGallery();
};

async function openScene(tid){
  SCENE = tid;
  const r = await fetch(`/scene/${tid}/meta`);
  if (!r.ok) { status.textContent = `task ${tid}: no scene data`; return; }
  META = await r.json();
  status.textContent = `scene ${tid}: ${META.num_views} views, ` +
    `${META.width}x${META.height}, depth ${META.depth_min.toFixed(1)}-${META.depth_max.toFixed(1)} m`;
  const sel = document.getElementById('viewsel');
  sel.innerHTML = '';
  for (let i = 0; i < META.num_views; i++)
    sel.appendChild(new Option('view ' + i, i));
  setView(0);
  document.getElementById('rendergs').disabled = !META.has_gs;
  loadExports(tid);
  await loadPoints();
}

/* ---------- depth tab ---------- */
function setView(i){
  if (!SCENE || !META) return;
  i = Math.max(0, Math.min(META.num_views - 1, i));
  document.getElementById('viewsel').value = i;
  document.getElementById('imgview').src = `/scene/${SCENE}/image/${i}.jpg`;
  document.getElementById('depthview').src = `/scene/${SCENE}/depth/${i}.png`;
}
document.getElementById('viewsel').onchange = e => setView(+e.target.value);
document.getElementById('prevv').onclick = () => setView(+viewsel.value - 1);
document.getElementById('nextv').onclick = () => setView(+viewsel.value + 1);
document.getElementById('depthview').onclick = async e => {
  const r = e.target.getBoundingClientRect();
  const u = (e.clientX - r.left) / r.width, v = (e.clientY - r.top) / r.height;
  const j = await (await fetch(`/scene/${SCENE}/measure?` + new URLSearchParams(
    {view: viewsel.value, u, v}))).json();
  document.getElementById('measureOut').textContent = j.depth === null ?
    'no depth at this pixel' :
    `depth at (${j.x}, ${j.y}): ${j.depth.toFixed(2)} m` + (j.sky ? ' (sky)' : '');
};

/* ---------- 3DGS tab ---------- */
document.getElementById('rendergs').onclick = async () => {
  const st = document.getElementById('gsstatus');
  st.textContent = 'rendering novel views on device...';
  const r = await fetch(`/scene/${SCENE}/gs_video`, {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({traj: document.getElementById('trj').value,
                          quality: document.getElementById('gsq').value})});
  const j = await r.json();
  if (j.file) { st.textContent = ''; const v = document.getElementById('gsvid');
    v.src = j.file; v.play(); }
  else st.textContent = 'error: ' + (j.error || 'render failed');
};

/* ---------- gallery + exports ---------- */
async function loadGallery(){
  const man = await (await fetch('/gallery/manifest')).json();
  const g = document.getElementById('gallery');
  g.innerHTML = '';
  for (const m of man.slice().reverse()) {
    const d = document.createElement('div');
    d.textContent = `${m.task_id} (${m.files.length} files)`;
    d.onclick = () => openScene(m.task_id);
    g.appendChild(d);
  }
}
async function loadExports(tid){
  const man = await (await fetch('/gallery/manifest')).json();
  const entry = man.find(m => m.task_id === tid);
  const e = document.getElementById('exports');
  e.innerHTML = '';
  for (const f of (entry ? entry.files : [])) {
    if (f === 'scene.npz') continue;
    const a = document.createElement('a');
    a.href = `/files/${tid}/${f}`; a.download = f; a.textContent = f;
    e.appendChild(a);
  }
}
loadGallery();
resize();
</script></body></html>"""
