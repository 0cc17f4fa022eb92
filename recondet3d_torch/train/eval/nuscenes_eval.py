"""Self-contained nuScenes detection evaluation: mAP + NDS, devkit-exact
(the port's copy of ``recondet3d/train/eval/nuscenes_eval.py``).

The reference evaluates through the nuScenes devkit's NuScenesEval
(reference: mmdetection3d/mmdet3d/datasets/nuscenes_dataset.py:424-489 —
mAP + NDS with per-class AP at center-distance thresholds {0.5, 1, 2, 4}m
and the TP errors ATE/ASE/AOE/AVE/AAE matched at 2m). The devkit is not
in this image; this module implements the devkit's published algorithm
(nuscenes/eval/detection/algo.py ``accumulate``/``calc_ap``/``calc_tp``
and ``DetectionMetrics``) bit-for-bit, including its edge cases:

- Matching: predictions of a class sorted by confidence descending; each
  matches the closest (2D center distance) not-yet-taken GT of the same
  class in the same sample; a match requires ``dist < dist_th``.
- Curves on a fixed 101-point recall grid; precision/confidence
  interpolated with ``right=0``.
- AP: precision grid clipped STRICTLY ABOVE min_recall (indices 11..100,
  i.e. 90 points), minus min_precision, clamped at 0, normalized by
  ``(1 - min_precision)`` — the devkit's ``calc_ap``.
- TP errors: cumulative means of per-match errors interpolated as a
  function of CONFIDENCE onto the grid's confidence curve, then averaged
  over indices ``11 .. max_recall_ind`` where ``max_recall_ind`` is the
  last grid index with nonzero interpolated confidence; 1.0 when the
  window is empty — the devkit's ``calc_tp``.
- Classes with zero GT → ``no_predictions`` (AP 0, errors 1) and still
  count toward mAP, exactly as every configured class does in the devkit.
- Attribute error is NaN when the GT attribute is empty; ``cummean`` is
  NaN-aware and returns ones for an all-NaN series.
- Class/metric exclusions (traffic_cone: attr/vel/orient; barrier:
  attr/vel) → NaN, aggregated with nanmean.
- NDS = (5·mAP + Σ max(1 − err, 0)) / 10 over the five TP metrics.

tests/test_torch_nuscenes_eval.py holds this copy against the JAX
package's on the same boxes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = [
    "DetectionBox", "evaluate_nuscenes", "accumulate", "calc_ap", "calc_tp",
    "DIST_THRESHOLDS",
]

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
DIST_TH_TP = 2.0
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_ELEM = 101
MEAN_AP_WEIGHT = 5


class DetectionBox(dict):
    """sample_token, translation (3,), size wlh (3,), yaw, velocity (2,),
    detection_name, detection_score, attribute_name."""

    def __init__(self, sample_token, translation, size, yaw, velocity,
                 detection_name, detection_score=1.0, attribute_name=""):
        super().__init__(
            sample_token=sample_token,
            translation=np.asarray(translation, np.float64),
            size=np.asarray(size, np.float64),
            yaw=float(yaw),
            velocity=np.asarray(velocity, np.float64),
            detection_name=detection_name,
            detection_score=float(detection_score),
            attribute_name=attribute_name,
        )

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


def _yaw_diff(a: float, b: float, period: float = 2 * np.pi) -> float:
    d = (a - b) % period
    return min(d, period - d)


def _scale_iou(gt_size, pred_size) -> float:
    """Aligned-at-origin 3D IoU of sizes (devkit scale_iou)."""
    mn = np.minimum(gt_size, pred_size)
    inter = np.prod(mn)
    union = np.prod(gt_size) + np.prod(pred_size) - inter
    return float(inter / union) if union > 0 else 0.0


def _cummean(x: np.ndarray) -> np.ndarray:
    """Devkit cummean: NaN-aware cumulative mean; ones for all-NaN input."""
    x = np.asarray(x, np.float64)
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    s = np.nancumsum(x)
    c = np.cumsum(~np.isnan(x)).astype(np.float64)
    return np.divide(s, c, out=np.zeros_like(s), where=c != 0)


class MetricData:
    """Per (class, dist_th) curves on the 101-point recall grid
    (devkit DetectionMetricData)."""

    def __init__(self, precision, confidence, errors: Dict[str, np.ndarray]):
        self.recall = np.linspace(0, 1, N_ELEM)
        self.precision = np.asarray(precision, np.float64)
        self.confidence = np.asarray(confidence, np.float64)
        self.errors = {k: np.asarray(v, np.float64) for k, v in errors.items()}

    @property
    def max_recall_ind(self) -> int:
        nz = np.nonzero(self.confidence)[0]
        return int(nz[-1]) if len(nz) else 0

    @classmethod
    def no_predictions(cls) -> "MetricData":
        return cls(np.zeros(N_ELEM), np.zeros(N_ELEM),
                   {k: np.ones(N_ELEM) for k in TP_METRICS})


def accumulate(gt_boxes: List[DetectionBox], pred_boxes: List[DetectionBox],
               dist_th: float) -> MetricData:
    """Devkit accumulate for one class + threshold; inputs pre-filtered to
    the class. Returns ``no_predictions`` when npos == 0 or nothing matched."""
    npos = len(gt_boxes)
    if npos == 0:
        return MetricData.no_predictions()
    preds = sorted(pred_boxes, key=lambda b: -b.detection_score)
    gt_by_sample: Dict[str, List[DetectionBox]] = {}
    for g in gt_boxes:
        gt_by_sample.setdefault(g.sample_token, []).append(g)
    taken = set()

    tp, fp, conf = [], [], []
    match_data = {k: [] for k in TP_METRICS}
    match_conf = []
    for p in preds:
        gts = gt_by_sample.get(p.sample_token, [])
        best, best_d = None, float("inf")
        for gi, g in enumerate(gts):
            if (p.sample_token, gi) in taken:
                continue
            d = np.linalg.norm(
                np.asarray(g.translation[:2]) - np.asarray(p.translation[:2])
            )
            if d < best_d:
                best, best_d = gi, d
        if best is not None and best_d < dist_th:
            taken.add((p.sample_token, best))
            tp.append(1); fp.append(0); conf.append(p.detection_score)
            g = gts[best]
            match_data["trans_err"].append(best_d)
            match_data["scale_err"].append(1 - _scale_iou(g.size, p.size))
            period = np.pi if g.detection_name == "barrier" else 2 * np.pi
            match_data["orient_err"].append(_yaw_diff(g.yaw, p.yaw, period))
            match_data["vel_err"].append(float(np.linalg.norm(
                np.asarray(g.velocity) - np.asarray(p.velocity))))
            # devkit attr_acc: NaN when the GT attribute is empty
            match_data["attr_err"].append(
                np.nan if not g.attribute_name
                else 1.0 - float(g.attribute_name == p.attribute_name)
            )
            match_conf.append(p.detection_score)
        else:
            tp.append(0); fp.append(1); conf.append(p.detection_score)

    if not match_conf:
        return MetricData.no_predictions()

    tp_c = np.cumsum(tp).astype(np.float64)
    fp_c = np.cumsum(fp).astype(np.float64)
    prec = tp_c / (tp_c + fp_c)
    rec = tp_c / float(npos)

    rec_grid = np.linspace(0, 1, N_ELEM)
    prec_i = np.interp(rec_grid, rec, prec, right=0)
    conf_i = np.interp(rec_grid, rec, conf, right=0)

    errors = {}
    mc = np.asarray(match_conf, np.float64)
    for k in TP_METRICS:
        tmp = _cummean(np.asarray(match_data[k]))
        # interpolate the cumulative mean as a function of confidence onto
        # the grid's confidence curve (reversed: np.interp needs ascending x)
        errors[k] = np.interp(conf_i[::-1], mc[::-1], tmp[::-1])[::-1]
    return MetricData(prec_i, conf_i, errors)


def calc_ap(md: MetricData, min_recall: float = MIN_RECALL,
            min_precision: float = MIN_PRECISION) -> float:
    """Devkit calc_ap: grid indices round(100·min_recall)+1 .. 100."""
    prec = np.copy(md.precision)
    prec = prec[round(100 * min_recall) + 1:]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def calc_tp(md: MetricData, metric_name: str,
            min_recall: float = MIN_RECALL) -> float:
    """Devkit calc_tp: mean over indices first..max_recall_ind inclusive;
    1.0 when the window is empty."""
    first = round(100 * min_recall) + 1
    last = md.max_recall_ind
    if last < first:
        return 1.0
    return float(np.mean(md.errors[metric_name][first:last + 1]))


def evaluate_nuscenes(
    gt_boxes: Sequence[DetectionBox],
    pred_boxes: Sequence[DetectionBox],
    class_names: Sequence[str],
    eval_vel_attr: bool = True,
) -> Dict:
    """Returns dict with 'mAP', 'NDS', per-class APs, and TP errors.

    Devkit-exact: every class in ``class_names`` counts toward mAP (zero-GT
    classes score 0), TP errors use nanmean with the devkit's class/metric
    exclusions, NDS always divides by 10 (5 + five TP metrics).
    ``eval_vel_attr=False`` additionally NaNs vel/attr for every class
    (KITTI-style boxes without velocity/attributes)."""
    aps: Dict[str, Dict[float, float]] = {}
    tp_cls: Dict[str, Dict[str, float]] = {}
    for cls in class_names:
        gts = [g for g in gt_boxes if g.detection_name == cls]
        preds = [p for p in pred_boxes if p.detection_name == cls]
        aps[cls] = {}
        for th in DIST_THRESHOLDS:
            md = accumulate(gts, preds, th)
            aps[cls][th] = calc_ap(md)
            if th == DIST_TH_TP:
                errs = {}
                for k in TP_METRICS:
                    if cls == "traffic_cone" and k in (
                            "attr_err", "vel_err", "orient_err"):
                        errs[k] = np.nan
                    elif cls == "barrier" and k in ("attr_err", "vel_err"):
                        errs[k] = np.nan
                    elif not eval_vel_attr and k in ("vel_err", "attr_err"):
                        errs[k] = np.nan
                    else:
                        errs[k] = calc_tp(md, k)
                tp_cls[cls] = errs

    class_aps = {cls: float(np.mean(list(v.values()))) for cls, v in aps.items()}
    mean_ap = float(np.mean(list(class_aps.values()))) if class_aps else 0.0

    tp_means = {}
    for k in TP_METRICS:
        vals = [tp_cls[cls][k] for cls in tp_cls]
        finite = [v for v in vals if not np.isnan(v)]
        # nanmean over classes; an all-NaN metric scores 0 in NDS, which the
        # 1.0 error here reproduces (devkit: max(0, 1 - nan) evaluates to 0)
        tp_means[k] = float(np.mean(finite)) if finite else 1.0

    tp_scores = [max(1.0 - tp_means[k], 0.0) for k in TP_METRICS]
    nds = float(
        (MEAN_AP_WEIGHT * mean_ap + sum(tp_scores))
        / (MEAN_AP_WEIGHT + len(tp_scores))
    )

    return dict(
        mAP=mean_ap,
        NDS=nds,
        class_aps=class_aps,
        aps_per_threshold=aps,
        tp_errors=tp_means,
    )
