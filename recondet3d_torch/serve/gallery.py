"""Gallery server: browse exported reconstructions in groups (port of
``recondet3d/serve/gallery.py``; standard library only, the same routes).

Re-implementation of the reference static gallery site
(reference: depth_anything_3/services/gallery.py:1-806 — a
SimpleHTTPRequestHandler subclass serving a two-level browsing SPA over a
``root/group/scene/`` tree, ``/manifest.json`` with the group list,
``/manifest/<group>.json`` with each scene's model/thumbnail/depth
images, URL-query routing, directory listings disabled, plain-name
validation).

Differences by design: the reference viewer overlay embeds
``<model-viewer>`` from a CDN; this environment is offline and the
exports are point clouds, so the overlay renders ``scene.glb`` directly
with an inline WebGL parser for the glTF POINTS/LINES primitives our
exporter writes (data/export/glb.py:26).
"""

from __future__ import annotations

import json
import os
import re
from http import HTTPStatus
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import unquote

__all__ = ["serve_gallery", "create_gallery_server", "build_group_list",
           "build_group_manifest"]

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp")

_PLAIN = re.compile(r"^[A-Za-z0-9._ -]+$")


def _is_plain_name(name: str) -> bool:
    return bool(name) and bool(_PLAIN.match(name)) and ".." not in name


def _scene_entry(root: str, group: str, sname: str):
    spath = os.path.join(root, group, sname) if group else os.path.join(root, sname)
    if not os.path.isdir(spath):
        return None
    glb = os.path.join(spath, "scene.glb")
    if not os.path.exists(glb):
        return None
    prefix = f"/{group}/{sname}" if group else f"/{sname}"
    entry = dict(id=sname, title=sname, model=f"{prefix}/scene.glb")
    thumb = os.path.join(spath, "scene.jpg")
    if os.path.exists(thumb):
        entry["thumbnail"] = f"{prefix}/scene.jpg"
    depth_images = []
    dpath = os.path.join(spath, "depth_vis")
    if os.path.isdir(dpath):
        for fn in sorted(os.listdir(dpath)):
            if os.path.splitext(fn)[1].lower() in IMAGE_EXTS:
                depth_images.append(f"{prefix}/depth_vis/{fn}")
    # flat task dirs (the backend's workdir/tasks layout) keep depth pngs
    # beside the glb
    for fn in sorted(os.listdir(spath)):
        if fn.startswith("depth_") and os.path.splitext(fn)[1].lower() in IMAGE_EXTS:
            depth_images.append(f"{prefix}/{fn}")
    entry["depth_images"] = depth_images
    if "thumbnail" not in entry and depth_images:
        entry["thumbnail"] = depth_images[0]
    return entry


def build_group_list(root: str) -> dict:
    """Top-level groups = subdirs containing at least one scene dir with a
    scene.glb (reference: gallery.py:641-665). Scene dirs directly under
    the root are collected into an implicit '' group."""
    groups = []
    flat = False
    for name in sorted(os.listdir(root)) if os.path.isdir(root) else []:
        path = os.path.join(root, name)
        if not os.path.isdir(path):
            continue
        if os.path.exists(os.path.join(path, "scene.glb")):
            flat = True
            continue
        if any(
            os.path.exists(os.path.join(path, s, "scene.glb"))
            for s in os.listdir(path)
            if os.path.isdir(os.path.join(path, s))
        ):
            groups.append(dict(id=name, title=name))
    if flat:
        groups.insert(0, dict(id="", title="(scenes)"))
    return dict(groups=groups)


def build_group_manifest(root: str, group: str) -> dict:
    """Scenes of one group (reference: gallery.py:668-703)."""
    gpath = os.path.join(root, group) if group else root
    items = []
    if os.path.isdir(gpath):
        for sname in sorted(os.listdir(gpath)):
            e = _scene_entry(root, group, sname)
            if e:
                items.append(e)
    return dict(group=group, items=items)


def create_gallery_server(root: str, host: str = "127.0.0.1", port: int = 8100):
    root = os.path.abspath(root)

    class Handler(SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=root, **kw)

        def log_message(self, *a):
            pass

        def _send(self, body: bytes, ctype: str, code=200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html") or self.path.startswith("/?"):
                return self._send(_GALLERY_HTML.encode(), "text/html; charset=utf-8")
            if self.path == "/manifest.json":
                return self._send(json.dumps(build_group_list(root)).encode(),
                                  "application/json")
            if self.path.startswith("/manifest/") and self.path.endswith(".json"):
                group = unquote(self.path[len("/manifest/"):-len(".json")])
                if group and not _is_plain_name(group):
                    return self._send(b'{"error": "bad group"}',
                                      "application/json", 400)
                return self._send(
                    json.dumps(build_group_manifest(root, group)).encode(),
                    "application/json")
            if self.path == "/manifest":  # legacy flat manifest
                entries = []
                for dirpath, _, files in os.walk(root):
                    rel = os.path.relpath(dirpath, root)
                    scene_files = [f for f in files
                                   if f.endswith((".glb", ".ply", ".npz"))]
                    if scene_files:
                        entries.append(dict(dir=rel, files=sorted(scene_files)))
                return self._send(json.dumps(entries).encode(), "application/json")
            if self.path == "/favicon.ico":
                self.send_response(HTTPStatus.NO_CONTENT)
                self.end_headers()
                return
            return super().do_GET()

        def list_directory(self, path):  # reference: listing disabled
            self.send_error(HTTPStatus.NOT_FOUND, "Directory listing disabled")
            return None

    return ThreadingHTTPServer((host, port), Handler)


def serve_gallery(root: str, host: str = "127.0.0.1", port: int = 8100):
    create_gallery_server(root, host, port).serve_forever()


_GALLERY_HTML = r"""<!doctype html><html><head><meta charset="utf-8">
<title>recondet3d gallery</title><style>
body{margin:0;font:14px system-ui,sans-serif;background:#14161a;color:#d8dce3}
h2{margin:18px}#grid{display:grid;grid-template-columns:repeat(auto-fill,
minmax(200px,1fr));gap:12px;padding:0 18px 18px}
.card{background:#1e2128;border:1px solid #333;border-radius:8px;cursor:pointer;
overflow:hidden}.card:hover{border-color:#4da3ff}
.card img{width:100%;height:130px;object-fit:cover;display:block;background:#000}
.card .t{padding:8px;font-size:13px;white-space:nowrap;overflow:hidden;
text-overflow:ellipsis}
#crumb{margin:18px;color:#8a91a0}#crumb a{color:#4da3ff;cursor:pointer}
#overlay{position:fixed;inset:0;background:#000d;display:none;z-index:9}
#overlay.show{display:flex;flex-direction:column}
#ovbar{display:flex;gap:12px;align-items:center;padding:10px;background:#1e2128}
#ovbar button{background:#343945;border:0;color:#fff;padding:6px 12px;
border-radius:4px;cursor:pointer}
#ovgl{flex:1;min-height:0}#ovgl canvas{width:100%;height:100%;display:block}
#strip{display:flex;gap:6px;overflow-x:auto;padding:8px;background:#111}
#strip img{height:90px;border:1px solid #333}
</style></head><body>
<div id=crumb></div><h2 id=title>Gallery</h2><div id=grid></div>
<div id=overlay><div id=ovbar><button onclick="closeViewer()">&#8592; back</button>
<span id=ovtitle></span></div><div id=ovgl><canvas id=ovc></canvas></div>
<div id=strip></div></div>
<script>
"use strict";
const qs = () => new URLSearchParams(location.search);
let SCENES = [];

async function enterLevel1(opts){
  const man = await (await fetch('/manifest.json')).json();
  document.getElementById('title').textContent = 'Gallery';
  document.getElementById('crumb').innerHTML = '';
  const g = document.getElementById('grid'); g.innerHTML = '';
  for (const grp of man.groups) {
    const c = document.createElement('div'); c.className = 'card';
    c.innerHTML = `<div class=t>&#128193; ${grp.title}</div>`;
    c.onclick = () => enterLevel2(grp.id, {push: true});
    g.appendChild(c);
  }
  if (!(opts && opts.push === false))
    history.pushState(null, '', '/');
}
async function enterLevel2(group, opts){
  const man = await (await fetch('/manifest/' + encodeURIComponent(group) + '.json')).json();
  SCENES = man.items;
  document.getElementById('title').textContent = group || '(scenes)';
  document.getElementById('crumb').innerHTML =
    '<a onclick="enterLevel1({push:true})">gallery</a> / ' + (group || 'scenes');
  const g = document.getElementById('grid'); g.innerHTML = '';
  for (const s of man.items) {
    const c = document.createElement('div'); c.className = 'card';
    c.innerHTML = (s.thumbnail ? `<img src="${s.thumbnail}">` : '') +
      `<div class=t>${s.title}</div>`;
    c.onclick = () => openViewer(s, {push: true});
    g.appendChild(c);
  }
  if (!(opts && opts.push === false))
    history.pushState(null, '', '/?group=' + encodeURIComponent(group));
}
function closeViewer(){
  document.getElementById('overlay').classList.remove('show');
  history.pushState(null, '', '/?group=' + encodeURIComponent(qs().get('group') || ''));
}

/* minimal GLB loader for our exporter's POINTS/LINES primitives */
async function loadGLB(url){
  const buf = await (await fetch(url)).arrayBuffer();
  const dv = new DataView(buf);
  if (dv.getUint32(0, true) !== 0x46546C67) throw 'not glb';
  const jlen = dv.getUint32(12, true);
  const gltf = JSON.parse(new TextDecoder().decode(new Uint8Array(buf, 20, jlen)));
  const binOff = 20 + jlen + 8;
  const acc = i => {
    const a = gltf.accessors[i], v = gltf.bufferViews[a.bufferView];
    const off = binOff + (v.byteOffset || 0);
    const n = a.count * (a.type === 'VEC3' ? 3 : 1);
    return a.componentType === 5126 ? new Float32Array(buf, off, n)
                                    : new Uint32Array(buf, off, n);
  };
  const prims = [];
  for (const m of gltf.meshes) for (const p of m.primitives)
    prims.push({mode: p.mode, pos: acc(p.attributes.POSITION),
                col: p.attributes.COLOR_0 !== undefined ? acc(p.attributes.COLOR_0) : null,
                idx: p.indices !== undefined ? acc(p.indices) : null});
  return prims;
}

/* WebGL viewer */
const canvas = document.getElementById('ovc');
const gl = canvas.getContext('webgl');
const prog = (() => {
  const mk = (t, s) => { const sh = gl.createShader(t); gl.shaderSource(sh, s);
    gl.compileShader(sh); return sh; };
  const p = gl.createProgram();
  gl.attachShader(p, mk(gl.VERTEX_SHADER,
    'attribute vec3 p;attribute vec3 c;uniform mat4 mvp;varying vec3 vc;' +
    'void main(){gl_Position=mvp*vec4(p,1.);gl_PointSize=2.0;vc=c;}'));
  gl.attachShader(p, mk(gl.FRAGMENT_SHADER,
    'precision mediump float;varying vec3 vc;void main(){gl_FragColor=vec4(vc,1.);}'));
  gl.linkProgram(p); return p;
})();
let DRAWS = [], center = [0,0,0], radius = 5,
    theta = -0.9, phi = 0.5, dist = 2.2;
function matMul(a,b){const o=new Float32Array(16);
  for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
    for(let k=0;k<4;k++)s+=a[k*4+j]*b[i*4+k];o[i*4+j]=s;}return o;}
function persp(f,a,n,fr){const t=1/Math.tan(f/2);
  return new Float32Array([t/a,0,0,0,0,t,0,0,0,0,(fr+n)/(n-fr),-1,0,0,2*fr*n/(n-fr),0]);}
function lookAt(e,c,u){const sb=(a,b)=>[a[0]-b[0],a[1]-b[1],a[2]-b[2]];
  const nm=v=>{const l=Math.hypot(...v)||1;return v.map(x=>x/l);};
  const cr=(a,b)=>[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];
  const z=nm(sb(e,c)),x=nm(cr(u,z)),y=cr(z,x);
  const d=v=>-(v[0]*e[0]+v[1]*e[1]+v[2]*e[2]);
  return new Float32Array([x[0],y[0],z[0],0,x[1],y[1],z[1],0,x[2],y[2],z[2],0,
    d(x),d(y),d(z),1]);}
function draw(){
  canvas.width = canvas.clientWidth * devicePixelRatio;
  canvas.height = canvas.clientHeight * devicePixelRatio;
  gl.viewport(0,0,canvas.width,canvas.height);
  gl.clearColor(0.05,0.06,0.08,1); gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  const eye=[center[0]+dist*radius*Math.cos(phi)*Math.cos(theta),
             center[1]-dist*radius*Math.sin(phi),
             center[2]+dist*radius*Math.cos(phi)*Math.sin(theta)];
  const mvp=matMul(persp(0.9,canvas.width/canvas.height,0.01*radius,100*radius),
                   lookAt(eye,center,[0,-1,0]));
  gl.useProgram(prog);
  gl.uniformMatrix4fv(gl.getUniformLocation(prog,'mvp'),false,mvp);
  const aP=gl.getAttribLocation(prog,'p'), aC=gl.getAttribLocation(prog,'c');
  for (const d of DRAWS){
    gl.bindBuffer(gl.ARRAY_BUFFER, d.pbuf);
    gl.enableVertexAttribArray(aP);
    gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
    gl.bindBuffer(gl.ARRAY_BUFFER, d.cbuf);
    gl.enableVertexAttribArray(aC);
    gl.vertexAttribPointer(aC,3,gl.FLOAT,false,0,0);
    if (d.ibuf){ gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,d.ibuf);
      gl.drawElements(gl.LINES,d.n,gl.UNSIGNED_INT,0); }
    else gl.drawArrays(gl.POINTS,0,d.n);
  }
}
gl.getExtension('OES_element_index_uint');
let drag=null;
canvas.onpointerdown=e=>drag=[e.clientX,e.clientY];
window.onpointerup=()=>drag=null;
window.onpointermove=e=>{if(!drag)return;
  theta+=(e.clientX-drag[0])*0.008;
  phi=Math.max(-1.5,Math.min(1.5,phi+(e.clientY-drag[1])*0.008));
  drag=[e.clientX,e.clientY];draw();};
canvas.onwheel=e=>{e.preventDefault();
  dist=Math.max(0.05,dist*Math.exp(e.deltaY*0.001));draw();};

async function openViewer(scene, opts){
  document.getElementById('overlay').classList.add('show');
  document.getElementById('ovtitle').textContent = scene.title;
  const strip = document.getElementById('strip'); strip.innerHTML = '';
  for (const d of scene.depth_images || []) {
    const im = document.createElement('img'); im.src = d; strip.appendChild(im);
  }
  const prims = await loadGLB(scene.model);
  DRAWS = []; let mn=[1e9,1e9,1e9], mx=[-1e9,-1e9,-1e9];
  for (const p of prims){
    const pbuf = gl.createBuffer();
    gl.bindBuffer(gl.ARRAY_BUFFER, pbuf);
    gl.bufferData(gl.ARRAY_BUFFER, p.pos, gl.STATIC_DRAW);
    const colors = p.col || new Float32Array(p.pos.length).fill(0.3).map(
      (v,i)=>i%3===2?1.0:0.8);
    const cbuf = gl.createBuffer();
    gl.bindBuffer(gl.ARRAY_BUFFER, cbuf);
    gl.bufferData(gl.ARRAY_BUFFER, colors instanceof Float32Array ? colors :
      new Float32Array(colors), gl.STATIC_DRAW);
    let ibuf=null, n=p.pos.length/3;
    if (p.idx){ ibuf=gl.createBuffer();
      gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,ibuf);
      gl.bufferData(gl.ELEMENT_ARRAY_BUFFER,p.idx,gl.STATIC_DRAW); n=p.idx.length; }
    DRAWS.push({pbuf,cbuf,ibuf,n});
    if (!p.idx) for (let i=0;i<p.pos.length;i+=3) for (let k=0;k<3;k++){
      const v=p.pos[i+k]; if(v<mn[k])mn[k]=v; if(v>mx[k])mx[k]=v; }
  }
  center=[(mn[0]+mx[0])/2,(mn[1]+mx[1])/2,(mn[2]+mx[2])/2];
  radius=Math.max(0.5,Math.hypot(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2])/2);
  draw();
  if (!(opts && opts.push === false))
    history.pushState(null, '', '/?group=' +
      encodeURIComponent(qs().get('group') || '') + '&id=' +
      encodeURIComponent(scene.id));
}

window.onpopstate = () => routeFromURL();
async function routeFromURL(){
  const g = qs().get('group'), id = qs().get('id');
  if (g === null) { enterLevel1({push: false}); return; }
  await enterLevel2(g, {push: false});
  if (id) {
    const hit = SCENES.find(x => x.id === id);
    if (hit) openViewer(hit, {push: false});
  } else document.getElementById('overlay').classList.remove('show');
}
routeFromURL();
</script></body></html>"""
