"""The browser page: canvas renderer + input + plotters + control panel
(the port's copy of the JAX package's page; only the package's name in the
title and heading differs).

Dependency-free (vanilla JS served as one HTML string) analog of the
original project's TypeScript front end:

* renderer vocabulary from its ``viz/src/renderer.ts``: floor line,
  bumper walls at ``±x_s``, cart body, pole link chain with mass circles,
  ghost predictions every 10th sample with alpha fade, applied-force
  arrows, mouse-interaction arrow, set-point marker;
* input semantics from ``input.ts:44-100``: nearest mass selected in
  pixel space at mousedown, held while clicked, incident angle
  ``atan2(my - py, mx - px)`` in canvas coordinates (the y-flip is part
  of the published force model);
* plotters from ``plotter.ts`` / ``application.ts:87-119``: u in
  [-150, 150], theta in [-180, 180] deg, cart speed in [-5, 5] m/s,
  5 major grid ticks;
* UI rows from ``application.ts:208-365``: controller checkbox, sim-rate
  + dynamics + set-point sliders, four terminal-cost slider/equality-
  checkbox pairs (equality = negative-weight convention), save-log and
  save-traces buttons.
"""

PAGE_HTML = r"""<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>cartpole_tpu_torch &mdash; interactive MPC</title>
<style>
  body { font-family: system-ui, sans-serif; background: #111418; color: #d7dde3;
         margin: 0; padding: 16px; }
  h1 { font-size: 18px; margin: 0 0 10px; font-weight: 600; }
  .row { display: flex; gap: 16px; flex-wrap: wrap; align-items: flex-start; }
  canvas { background: #1a1f26; border-radius: 8px; touch-action: none; }
  .panel { background: #1a1f26; border-radius: 8px; padding: 12px 16px;
           min-width: 300px; font-size: 13px; }
  .panel label { display: inline-block; width: 128px; }
  .panel .ctl { display: flex; align-items: center; gap: 8px; margin: 4px 0; }
  .panel input[type=range] { flex: 1; }
  .panel output { width: 72px; text-align: right; font-variant-numeric: tabular-nums; }
  .plots { display: flex; flex-direction: column; gap: 8px; }
  .plots .cap { font-size: 12px; color: #8b949e; margin-top: 2px; }
  button { background: #2d333b; color: #d7dde3; border: 1px solid #444c56;
           border-radius: 6px; padding: 4px 10px; cursor: pointer; }
  button:hover { background: #3a424c; }
  #status { font-size: 12px; color: #8b949e; margin-top: 8px; }
</style>
</head>
<body>
<h1>cartpole_tpu_torch &mdash; MPC swing-up (drag on the canvas to poke)</h1>
<div class="row">
  <div>
    <canvas id="cartPoleCanvas" width="760" height="380"></canvas>
    <div id="status"></div>
  </div>
  <div class="plots">
    <canvas id="controlPlot" width="320" height="110"></canvas>
    <div class="cap">control u (N)</div>
    <canvas id="anglePlot" width="320" height="110"></canvas>
    <div class="cap">&theta;&#8321; (deg)</div>
    <canvas id="speedPlot" width="320" height="110"></canvas>
    <div class="cap">cart speed (m/s)</div>
  </div>
  <div class="panel">
    <div class="ctl"><label>controller</label>
      <input type="checkbox" id="enableControllerCheckbox" checked></div>
    <div class="ctl"><label>sim rate</label>
      <input type="range" id="simRateSlider"><output id="simRateOutput"></output></div>
    <div class="ctl"><label>cart mass</label>
      <input type="range" id="baseMassSlider"><output id="baseMassOutput"></output></div>
    <div class="ctl"><label>pole mass</label>
      <input type="range" id="poleMassSlider"><output id="poleMassOutput"></output></div>
    <div class="ctl"><label>arm length</label>
      <input type="range" id="armLengthSlider"><output id="armLengthOutput"></output></div>
    <div class="ctl"><label>cart friction</label>
      <input type="range" id="cartFrictionSlider"><output id="cartFrictionOutput"></output></div>
    <div class="ctl"><label>mass drag</label>
      <input type="range" id="massDragSlider"><output id="massDragOutput"></output></div>
    <div class="ctl"><label>cart set-point</label>
      <input type="range" id="cartSetPointSlider"><output id="cartSetPointOutput"></output></div>
    <hr style="border-color:#2d333b">
    <div class="ctl"><label>b_x cost / eq</label>
      <input type="range" id="bxCostSlider"><input type="checkbox" id="bxCostCheckbox">
      <output id="bxCostOutput"></output></div>
    <div class="ctl"><label>&theta; cost / eq</label>
      <input type="range" id="thetaCostSlider"><input type="checkbox" id="thetaCostCheckbox">
      <output id="thetaCostOutput"></output></div>
    <div class="ctl"><label>b_x_dot cost / eq</label>
      <input type="range" id="bxDotCostSlider"><input type="checkbox" id="bxDotCostCheckbox">
      <output id="bxDotCostOutput"></output></div>
    <div class="ctl"><label>&theta;_dot cost / eq</label>
      <input type="range" id="thetaDotCostSlider"><input type="checkbox" id="thetaDotCostCheckbox">
      <output id="thetaDotCostOutput"></output></div>
    <hr style="border-color:#2d333b">
    <div class="ctl">
      <button id="resetButton">Reset</button>
      <button id="saveLogButton">Save log</button>
      <button id="saveTracesButton">Save traces</button>
    </div>
  </div>
</div>
<script>
"use strict";
const canvas = document.getElementById('cartPoleCanvas');
const ctx = canvas.getContext('2d');
let latest = null;          // last /state snapshot
let mouse = null;           // {x, y} in canvas px
let mouseDown = false;
let activeIndex = null;     // held mass while clicked (input.ts:68-82)

// ---------------------------------------------------------------- transform
// Metric -> pixel. Span sized so the bumper walls (x_s) stay visible.
// The double-pole model carries no springs (no x_s field): fall back to
// the single model's wall position for the viewport span.
function wallX(s) {
  return s.dynamics.x_s !== undefined ? s.dynamics.x_s : 0.8;
}
function transform(s) {
  const span = 2.0 * (wallX(s) + 0.55);
  const scale = canvas.width / span;
  const cy = canvas.height * 0.62;      // floor line
  return {
    scale: scale,
    toPx: (x, y) => [canvas.width / 2 + x * scale, cy - y * scale],
    fromPxAngle: (mx, my, px, py) => Math.atan2(my - py, mx - px),
  };
}

function massPixelLocations(s, tf) {
  return s.masses.map((p) => tf.toPx(p[0], p[1]));
}

// ------------------------------------------------------------------- render
function drawChain(s, tf, x, alpha, color) {
  // One cart + link chain at state vector x (renderer.ts drawSingle).
  ctx.globalAlpha = alpha;
  const [cx, cyp] = tf.toPx(x[0], 0);
  const w = 0.14 * tf.scale, h = 0.07 * tf.scale;
  ctx.fillStyle = color;
  ctx.fillRect(cx - w / 2, cyp - h / 2, w, h);
  let jx = x[0], jy = 0.0;
  for (let i = 0; i < s.lengths.length; i++) {
    const th = x[1 + i];
    const tx = jx + s.lengths[i] * Math.cos(th);
    const ty = jy + s.lengths[i] * Math.sin(th);
    const [p0x, p0y] = tf.toPx(jx, jy);
    const [p1x, p1y] = tf.toPx(tx, ty);
    ctx.strokeStyle = color;
    ctx.lineWidth = 3;
    ctx.beginPath(); ctx.moveTo(p0x, p0y); ctx.lineTo(p1x, p1y); ctx.stroke();
    ctx.beginPath(); ctx.arc(p1x, p1y, 6, 0, 2 * Math.PI); ctx.fill();
    jx = tx; jy = ty;
  }
  ctx.globalAlpha = 1.0;
}

function drawArrow(fromPx, angle, lenPx, color) {
  const [x0, y0] = fromPx;
  const x1 = x0 + Math.cos(angle) * lenPx, y1 = y0 + Math.sin(angle) * lenPx;
  ctx.strokeStyle = color; ctx.fillStyle = color; ctx.lineWidth = 2;
  ctx.beginPath(); ctx.moveTo(x0, y0); ctx.lineTo(x1, y1); ctx.stroke();
  ctx.beginPath();
  ctx.moveTo(x1, y1);
  ctx.lineTo(x1 - 8 * Math.cos(angle - 0.4), y1 - 8 * Math.sin(angle - 0.4));
  ctx.lineTo(x1 - 8 * Math.cos(angle + 0.4), y1 - 8 * Math.sin(angle + 0.4));
  ctx.fill();
}

function draw() {
  if (!latest) return;
  const s = latest;
  const tf = transform(s);
  ctx.clearRect(0, 0, canvas.width, canvas.height);

  // Floor + bumper walls at +/- x_s (renderer.ts vocabulary).
  const [, floorY] = tf.toPx(0, 0);
  ctx.strokeStyle = '#444c56'; ctx.lineWidth = 2;
  ctx.beginPath(); ctx.moveTo(0, floorY + 10); ctx.lineTo(canvas.width, floorY + 10); ctx.stroke();
  if (s.dynamics.x_s !== undefined) {
    for (const wx of [-s.dynamics.x_s, s.dynamics.x_s]) {
      const [px] = tf.toPx(wx, 0);
      ctx.strokeStyle = '#6b4b3e';
      ctx.beginPath(); ctx.moveTo(px, floorY + 10); ctx.lineTo(px, floorY - 40); ctx.stroke();
    }
  }
  // Set-point marker.
  const [spx] = tf.toPx(s.set_point, 0);
  ctx.fillStyle = '#3fb950';
  ctx.beginPath();
  ctx.moveTo(spx, floorY + 10); ctx.lineTo(spx - 5, floorY + 18); ctx.lineTo(spx + 5, floorY + 18);
  ctx.fill();

  // Ghost predictions every 10th sample, alpha fade (renderer.ts ghosts).
  if (s.predicted) {
    for (let i = 0; i < s.predicted.length; i += 10) {
      const a = 0.35 * (1.0 - i / s.predicted.length);
      drawChain(s, tf, s.predicted[i], a, '#58a6ff');
    }
  }
  // Live plant.
  drawChain(s, tf, s.x, 1.0, '#e6edf3');

  // Applied external forces (decaying pokes).
  const massPx = massPixelLocations(s, tf);
  s.forces.forEach((f, i) => {
    const mag = Math.hypot(f[0], f[1]);
    if (mag > 1e-3) {
      // Metric force direction -> canvas angle (y flip).
      const ang = Math.atan2(-f[1], f[0]);
      drawArrow(massPx[i], ang, Math.min(60, 6 * mag), '#f85149');
    }
  });
  // Mouse interaction arrow (input.ts determineInteraction).
  if (mouse) {
    const idx = currentMassIndex(massPx);
    const ang = tf.fromPxAngle(mouse.x, mouse.y, massPx[idx][0], massPx[idx][1]);
    drawArrow(massPx[idx], ang, 40, mouseDown ? '#f85149' : '#8b949e');
  }

  document.getElementById('status').textContent =
    `model=${s.model} tick=${s.tick} u=${s.u0.toFixed(1)} N ` +
    `b_x=${s.x[0].toFixed(2)} m th=${(s.x[1] * 180 / Math.PI).toFixed(1)} deg ` +
    `ctrl=${s.enabled ? 'on' : 'off'}`;

  drawPlot('controlPlot', s.plots.control, 150);
  drawPlot('anglePlot', s.plots.angle, 180);
  drawPlot('speedPlot', s.plots.speed, 5);
}

// Strip chart with 5 major grid ticks (plotter.ts / application.ts:87-119)
// and a mouse-hover reticule with value readout (plotter.ts:265-300).
const plotHover = {};  // canvas id -> {x, y} in canvas px
function plotMouse(id) {
  const c = document.getElementById(id);
  c.addEventListener('mousemove', (e) => {
    const r = c.getBoundingClientRect();
    plotHover[id] = { x: e.clientX - r.left, y: e.clientY - r.top };
  });
  c.addEventListener('mouseleave', () => { plotHover[id] = null; });
}
['controlPlot', 'anglePlot', 'speedPlot'].forEach(plotMouse);

function drawPlot(id, data, yLim) {
  const c = document.getElementById(id);
  const g = c.getContext('2d');
  g.clearRect(0, 0, c.width, c.height);
  g.strokeStyle = '#2d333b'; g.lineWidth = 1;
  for (let i = 0; i <= 4; i++) {
    const y = (i / 4) * c.height, x = (i / 4) * c.width;
    g.beginPath(); g.moveTo(0, y); g.lineTo(c.width, y); g.stroke();
    g.beginPath(); g.moveTo(x, 0); g.lineTo(x, c.height); g.stroke();
  }
  if (!data || data.t.length < 2) return;
  const t0 = data.t[0], t1 = data.t[data.t.length - 1];
  const toX = (t) => ((t - t0) / Math.max(t1 - t0, 1e-9)) * c.width;
  const toY = (y) => c.height / 2 - (y / yLim) * (c.height / 2);
  g.strokeStyle = '#58a6ff'; g.lineWidth = 1.5;
  g.beginPath();
  for (let i = 0; i < data.t.length; i++) {
    if (i === 0) g.moveTo(toX(data.t[i]), toY(data.y[i]));
    else g.lineTo(toX(data.t[i]), toY(data.y[i]));
  }
  g.stroke();
  const hov = plotHover[id];
  if (hov) {
    // Nearest sample to the cursor x: vertical reticule + value readout.
    let best = 0, bestD = Infinity;
    for (let i = 0; i < data.t.length; i++) {
      const d = Math.abs(toX(data.t[i]) - hov.x);
      if (d < bestD) { bestD = d; best = i; }
    }
    const rx = toX(data.t[best]), ry = toY(data.y[best]);
    g.strokeStyle = '#8b949e'; g.lineWidth = 1;
    g.beginPath(); g.moveTo(rx, 0); g.lineTo(rx, c.height); g.stroke();
    g.fillStyle = '#e6edf3';
    g.beginPath(); g.arc(rx, ry, 3, 0, 2 * Math.PI); g.fill();
    g.font = '11px system-ui';
    const label = `t=${data.t[best].toFixed(2)} y=${data.y[best].toFixed(2)}`;
    g.fillText(label, Math.min(rx + 6, c.width - 110), Math.max(ry - 6, 12));
  }
}

// -------------------------------------------------------------------- input
function currentMassIndex(massPx) {
  if (activeIndex !== null) return activeIndex;  // held (input.ts:68-82)
  let best = 0, bestD = Infinity;
  massPx.forEach((p, i) => {
    const d = Math.hypot(mouse.x - p[0], mouse.y - p[1]);
    if (d < bestD) { bestD = d; best = i; }
  });
  return best;
}

function canvasPos(e) {
  const r = canvas.getBoundingClientRect();
  const src = e.touches ? e.touches[0] : e;
  return { x: src.clientX - r.left, y: src.clientY - r.top };
}
canvas.addEventListener('mousemove', (e) => { mouse = canvasPos(e); });
canvas.addEventListener('mousedown', (e) => {
  mouse = canvasPos(e); mouseDown = true;
});
canvas.addEventListener('mouseup', () => { mouseDown = false; activeIndex = null; });
canvas.addEventListener('mouseleave', () => {
  mouse = null; mouseDown = false; activeIndex = null;
});
canvas.addEventListener('touchstart', (e) => {
  mouse = canvasPos(e); mouseDown = true; e.preventDefault();
});
canvas.addEventListener('touchmove', (e) => { mouse = canvasPos(e); e.preventDefault(); });
canvas.addEventListener('touchend', () => { mouseDown = false; activeIndex = null; mouse = null; });

async function post(path, body) {
  await fetch(path, { method: 'POST', body: JSON.stringify(body || {}) });
}

// Clicked: apply the poke at the selected mass every frame while held
// (application.ts:474-489 applies per animation frame).
async function maybePoke(s, tf) {
  if (!mouse || !mouseDown) return;
  const massPx = massPixelLocations(s, tf);
  const idx = currentMassIndex(massPx);
  activeIndex = idx;
  const ang = tf.fromPxAngle(mouse.x, mouse.y, massPx[idx][0], massPx[idx][1]);
  await post('/poke', { mass_index: idx, incident_angle: ang });
}

// --------------------------------------------------------------------- poll
async function poll() {
  try {
    const r = await fetch('/state');
    latest = await r.json();
    if (mouseDown) await maybePoke(latest, transform(latest));
    draw();
  } catch (e) { /* server restarting; keep polling */ }
}
setInterval(poll, 33);

// ----------------------------------------------------------------- controls
function slider(id, min, max, step, initial, onInput, fmt) {
  const el = document.getElementById(id + 'Slider');
  const out = document.getElementById(id + 'Output');
  if (initial === undefined) {  // field absent on this model: hide the row
    el.closest('.ctl').style.display = 'none';
    return;
  }
  el.min = min; el.max = max; el.step = step; el.value = initial;
  out.textContent = (fmt || ((v) => v.toFixed(2)))(initial);
  el.addEventListener('input', () => {
    const v = Math.min(Math.max(parseFloat(el.value), min), max);
    out.textContent = (fmt || ((v) => v.toFixed(2)))(v);
    onInput(v);
  });
}

// Cost slider + equality checkbox; equality = negative weight
// (application.ts:279-342 convention).
function costControl(id, field, initialWeight) {
  const el = document.getElementById(id + 'Slider');
  const cb = document.getElementById(id + 'Checkbox');
  const out = document.getElementById(id + 'Output');
  const eq = initialWeight < 0;
  el.min = 0; el.max = 200; el.step = 1;
  el.value = eq ? 100 : initialWeight;
  el.disabled = eq;
  cb.checked = eq;
  out.textContent = eq ? 'eq' : Number(el.value).toFixed(0);
  const apply = () => {
    const eqNow = cb.checked;
    el.disabled = eqNow;
    const w = eqNow ? -1.0 : parseFloat(el.value);
    out.textContent = eqNow ? 'eq' : w.toFixed(0);
    post('/optimization', { [field]: w });
  };
  cb.addEventListener('change', apply);
  el.addEventListener('change', apply);
}

async function initControls() {
  const r = await fetch('/state');
  const s = await r.json();
  const d = s.dynamics, o = s.optimization;
  slider('simRate', 0.0, 1.0, 0.01, s.sim_rate, (v) => post('/control', { sim_rate: v }));
  slider('baseMass', 0.1, 2.0, 0.01, d.m_b, (v) => post('/dynamics', { m_b: v }));
  slider('poleMass', 0.1, 1.0, 0.01, d.m_1, (v) => post('/dynamics', { m_1: v }));
  slider('armLength', 0.05, 0.5, 0.01, d.l_1, (v) => post('/dynamics', { l_1: v }));
  slider('cartFriction', 0.01, 0.5, 0.01, d.mu_b, (v) => post('/dynamics', { mu_b: v }));
  slider('massDrag', 0.01, 0.15, 0.01, d.c_d_1, (v) => post('/dynamics', { c_d_1: v }));
  slider('cartSetPoint', -1.0, 1.0, 0.01, s.set_point, (v) => post('/control', { set_point: v }));
  costControl('bxCost', 'b_x_final_cost_weight', o.b_x_final_cost_weight);
  costControl('thetaCost', 'th_final_cost_weight', o.th_final_cost_weight);
  costControl('bxDotCost', 'b_x_dot_final_cost_weight', o.b_x_dot_final_cost_weight);
  costControl('thetaDotCost', 'th_dot_final_cost_weight', o.th_dot_final_cost_weight);
  document.getElementById('enableControllerCheckbox').checked = s.enabled;
  document.getElementById('enableControllerCheckbox').addEventListener(
    'change', (e) => post('/control', { enabled: e.target.checked }));
  document.getElementById('resetButton').addEventListener('click', () => post('/reset'));
  document.getElementById('saveLogButton').addEventListener(
    'click', () => download('/log', 'log.json'));
  document.getElementById('saveTracesButton').addEventListener(
    'click', () => download('/traces', 'traces.json'));
  if (!s.tracing) document.getElementById('saveTracesButton').style.display = 'none';
}

async function download(path, filename) {
  const r = await fetch(path);
  const blob = await r.blob();
  const a = document.createElement('a');
  a.href = URL.createObjectURL(blob);
  a.download = filename;
  a.click();
  URL.revokeObjectURL(a.href);
}

initControls();
</script>
</body>
</html>
"""
