"""Loss logging of the trainer, and the debug images.

The port's copy of ``Visualizer`` from ``unopticalflow_tpu/utils/visualizer.py``:
it accumulates log packs (the interleaved evaluation's result strings),
pickles them to ``log.pkl``, and prints the four flow losses in the
reference trainer's ``iter: N, loss_pixel: ...`` format.
``VisualizerDebug`` writes the JAX package's debug images through
``utils/imageio.py``, under the JAX package's file names: as PNG an image,
a mask, a depth map and a flow's colour wheel (``test.py --task demo``),
float images stored as ``cv2.imwrite`` stores them (rounded and saturated
to uint8); as JPEG a disparity in the magma colormap
(``depth_harness.test_single_image``), the bytes PIL writes.  Its drawing
tools (correspondences, epipolar lines) draw the pixels cv2 draws, through
``utils/drawing.py``, and its 3-D ray tools call ``plot3D`` and ``scatter``
on any ``ax`` given them.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from unopticalflow_tpu_torch.evaluation.flowlib import flow_to_image
from unopticalflow_tpu_torch.utils import drawing, imageio

_LOSSES = ("loss_pixel", "loss_ssim", "loss_flow_smooth", "loss_flow_consis")

# matplotlib's "magma" colormap: its 256 RGB entries, copied once from
# matplotlib (``matplotlib.cm.magma``; tests/test_torch_visualizer.py holds them to it)
_MAGMA = np.array([
    (0.001462, 0.000466, 0.013866), (0.002258, 0.001295, 0.018331), (0.003279, 0.002305, 0.023708),
    (0.004512, 0.00349, 0.029965), (0.00595, 0.004843, 0.03713), (0.007588, 0.006356, 0.044973),
    (0.009426, 0.008022, 0.052844), (0.011465, 0.009828, 0.06075), (0.013708, 0.011771, 0.068667),
    (0.016156, 0.01384, 0.076603), (0.018815, 0.016026, 0.084584), (0.021692, 0.01832, 0.09261),
    (0.024792, 0.020715, 0.100676), (0.028123, 0.023201, 0.108787), (0.031696, 0.025765, 0.116965),
    (0.03552, 0.028397, 0.125209), (0.039608, 0.03109, 0.133515), (0.04383, 0.03383, 0.141886),
    (0.048062, 0.036607, 0.150327), (0.05232, 0.039407, 0.158841), (0.056615, 0.04216, 0.167446),
    (0.060949, 0.044794, 0.176129), (0.06533, 0.047318, 0.184892), (0.069764, 0.049726, 0.193735),
    (0.074257, 0.052017, 0.20266), (0.078815, 0.054184, 0.211667), (0.083446, 0.056225, 0.220755),
    (0.088155, 0.058133, 0.229922), (0.092949, 0.059904, 0.239164), (0.097833, 0.061531, 0.248477),
    (0.102815, 0.06301, 0.257854), (0.107899, 0.064335, 0.267289), (0.113094, 0.065492, 0.276784),
    (0.118405, 0.066479, 0.286321), (0.123833, 0.067295, 0.295879), (0.12938, 0.067935, 0.305443),
    (0.135053, 0.068391, 0.315), (0.140858, 0.068654, 0.324538), (0.146785, 0.068738, 0.334011),
    (0.152839, 0.068637, 0.343404), (0.159018, 0.068354, 0.352688), (0.165308, 0.067911, 0.361816),
    (0.171713, 0.067305, 0.370771), (0.178212, 0.066576, 0.379497), (0.184801, 0.065732, 0.387973),
    (0.19146, 0.064818, 0.396152), (0.198177, 0.063862, 0.404009), (0.204935, 0.062907, 0.411514),
    (0.211718, 0.061992, 0.418647), (0.218512, 0.061158, 0.425392), (0.225302, 0.060445, 0.431742),
    (0.232077, 0.059889, 0.437695), (0.238826, 0.059517, 0.443256), (0.245543, 0.059352, 0.448436),
    (0.25222, 0.059415, 0.453248), (0.258857, 0.059706, 0.45771), (0.265447, 0.060237, 0.46184),
    (0.271994, 0.060994, 0.46566), (0.278493, 0.061978, 0.46919), (0.284951, 0.063168, 0.472451),
    (0.291366, 0.064553, 0.475462), (0.29774, 0.066117, 0.478243), (0.304081, 0.067835, 0.480812),
    (0.310382, 0.069702, 0.483186), (0.316654, 0.07169, 0.48538), (0.322899, 0.073782, 0.487408),
    (0.329114, 0.075972, 0.489287), (0.335308, 0.078236, 0.491024), (0.341482, 0.080564, 0.492631),
    (0.347636, 0.082946, 0.494121), (0.353773, 0.085373, 0.495501), (0.359898, 0.087831, 0.496778),
    (0.366012, 0.090314, 0.49796), (0.372116, 0.092816, 0.499053), (0.378211, 0.095332, 0.500067),
    (0.384299, 0.097855, 0.501002), (0.390384, 0.100379, 0.501864), (0.396467, 0.102902, 0.502658),
    (0.402548, 0.10542, 0.503386), (0.408629, 0.10793, 0.504052), (0.414709, 0.110431, 0.504662),
    (0.420791, 0.11292, 0.505215), (0.426877, 0.115395, 0.505714), (0.432967, 0.117855, 0.50616),
    (0.439062, 0.120298, 0.506555), (0.445163, 0.122724, 0.506901), (0.451271, 0.125132, 0.507198),
    (0.457386, 0.127522, 0.507448), (0.463508, 0.129893, 0.507652), (0.46964, 0.132245, 0.507809),
    (0.47578, 0.134577, 0.507921), (0.481929, 0.136891, 0.507989), (0.488088, 0.139186, 0.508011),
    (0.494258, 0.141462, 0.507988), (0.500438, 0.143719, 0.50792), (0.506629, 0.145958, 0.507806),
    (0.512831, 0.148179, 0.507648), (0.519045, 0.150383, 0.507443), (0.52527, 0.152569, 0.507192),
    (0.531507, 0.154739, 0.506895), (0.537755, 0.156894, 0.506551), (0.544015, 0.159033, 0.506159),
    (0.550287, 0.161158, 0.505719), (0.556571, 0.163269, 0.50523), (0.562866, 0.165368, 0.504692),
    (0.569172, 0.167454, 0.504105), (0.57549, 0.16953, 0.503466), (0.581819, 0.171596, 0.502777),
    (0.588158, 0.173652, 0.502035), (0.594508, 0.175701, 0.501241), (0.600868, 0.177743, 0.500394),
    (0.607238, 0.179779, 0.499492), (0.613617, 0.181811, 0.498536), (0.620005, 0.18384, 0.497524),
    (0.626401, 0.185867, 0.496456), (0.632805, 0.187893, 0.495332), (0.639216, 0.189921, 0.49415),
    (0.645633, 0.191952, 0.49291), (0.652056, 0.193986, 0.491611), (0.658483, 0.196027, 0.490253),
    (0.664915, 0.198075, 0.488836), (0.671349, 0.200133, 0.487358), (0.677786, 0.202203, 0.485819),
    (0.684224, 0.204286, 0.484219), (0.690661, 0.206384, 0.482558), (0.697098, 0.208501, 0.480835),
    (0.703532, 0.210638, 0.479049), (0.709962, 0.212797, 0.477201), (0.716387, 0.214982, 0.47529),
    (0.722805, 0.217194, 0.473316), (0.729216, 0.219437, 0.471279), (0.735616, 0.221713, 0.46918),
    (0.742004, 0.224025, 0.467018), (0.748378, 0.226377, 0.464794), (0.754737, 0.228772, 0.462509),
    (0.761077, 0.231214, 0.460162), (0.767398, 0.233705, 0.457755), (0.773695, 0.236249, 0.455289),
    (0.779968, 0.238851, 0.452765), (0.786212, 0.241514, 0.450184), (0.792427, 0.244242, 0.447543),
    (0.798608, 0.24704, 0.444848), (0.804752, 0.249911, 0.442102), (0.810855, 0.252861, 0.439305),
    (0.816914, 0.255895, 0.436461), (0.822926, 0.259016, 0.433573), (0.828886, 0.262229, 0.430644),
    (0.834791, 0.26554, 0.427671), (0.840636, 0.268953, 0.424666), (0.846416, 0.272473, 0.421631),
    (0.852126, 0.276106, 0.418573), (0.857763, 0.279857, 0.415496), (0.86332, 0.283729, 0.412403),
    (0.868793, 0.287728, 0.409303), (0.874176, 0.291859, 0.406205), (0.879464, 0.296125, 0.403118),
    (0.884651, 0.30053, 0.400047), (0.889731, 0.305079, 0.397002), (0.8947, 0.309773, 0.393995),
    (0.899552, 0.314616, 0.391037), (0.904281, 0.31961, 0.388137), (0.908884, 0.324755, 0.385308),
    (0.913354, 0.330052, 0.382563), (0.917689, 0.3355, 0.379915), (0.921884, 0.341098, 0.377376),
    (0.925937, 0.346844, 0.374959), (0.929845, 0.352734, 0.372677), (0.933606, 0.358764, 0.370541),
    (0.937221, 0.364929, 0.368567), (0.940687, 0.371224, 0.366762), (0.944006, 0.377643, 0.365136),
    (0.94718, 0.384178, 0.363701), (0.95021, 0.39082, 0.362468), (0.953099, 0.397563, 0.361438),
    (0.955849, 0.4044, 0.360619), (0.958464, 0.411324, 0.360014), (0.960949, 0.418323, 0.35963),
    (0.96331, 0.42539, 0.359469), (0.965549, 0.432519, 0.359529), (0.967671, 0.439703, 0.35981),
    (0.96968, 0.446936, 0.360311), (0.971582, 0.45421, 0.36103), (0.973381, 0.46152, 0.361965),
    (0.975082, 0.468861, 0.363111), (0.97669, 0.476226, 0.364466), (0.97821, 0.483612, 0.366025),
    (0.979645, 0.491014, 0.367783), (0.981, 0.498428, 0.369734), (0.982279, 0.505851, 0.371874),
    (0.983485, 0.51328, 0.374198), (0.984622, 0.520713, 0.376698), (0.985693, 0.528148, 0.379371),
    (0.9867, 0.535582, 0.38221), (0.987646, 0.543015, 0.38521), (0.988533, 0.550446, 0.388365),
    (0.989363, 0.557873, 0.391671), (0.990138, 0.565296, 0.395122), (0.990871, 0.572706, 0.398714),
    (0.991558, 0.580107, 0.402441), (0.992196, 0.587502, 0.406299), (0.992785, 0.594891, 0.410283),
    (0.993326, 0.602275, 0.41439), (0.993834, 0.609644, 0.418613), (0.994309, 0.616999, 0.42295),
    (0.994738, 0.62435, 0.427397), (0.995122, 0.631696, 0.431951), (0.99548, 0.639027, 0.436607),
    (0.99581, 0.646344, 0.441361), (0.996096, 0.653659, 0.446213), (0.996341, 0.660969, 0.45116),
    (0.99658, 0.668256, 0.456192), (0.996775, 0.675541, 0.461314), (0.996925, 0.682828, 0.466526),
    (0.997077, 0.690088, 0.471811), (0.997186, 0.697349, 0.477182), (0.997254, 0.704611, 0.482635),
    (0.997325, 0.711848, 0.488154), (0.997351, 0.719089, 0.493755), (0.997351, 0.726324, 0.499428),
    (0.997341, 0.733545, 0.505167), (0.997285, 0.740772, 0.510983), (0.997228, 0.747981, 0.516859),
    (0.997138, 0.75519, 0.522806), (0.997019, 0.762398, 0.528821), (0.996898, 0.769591, 0.534892),
    (0.996727, 0.776795, 0.541039), (0.996571, 0.783977, 0.547233), (0.996369, 0.791167, 0.553499),
    (0.996162, 0.798348, 0.55982), (0.995932, 0.805527, 0.566202), (0.99568, 0.812706, 0.572645),
    (0.995424, 0.819875, 0.57914), (0.995131, 0.827052, 0.585701), (0.994851, 0.834213, 0.592307),
    (0.994524, 0.841387, 0.598983), (0.994222, 0.84854, 0.605696), (0.993866, 0.855711, 0.612482),
    (0.993545, 0.862859, 0.619299), (0.99317, 0.870024, 0.626189), (0.992831, 0.877168, 0.633109),
    (0.99244, 0.88433, 0.640099), (0.992089, 0.89147, 0.647116), (0.991688, 0.898627, 0.654202),
    (0.991332, 0.905763, 0.661309), (0.99093, 0.912915, 0.668481), (0.99057, 0.920049, 0.675675),
    (0.990175, 0.927196, 0.682926), (0.989815, 0.934329, 0.690198), (0.989434, 0.94147, 0.697519),
    (0.989077, 0.948604, 0.704863), (0.988717, 0.955742, 0.712242), (0.988367, 0.962878, 0.719649),
    (0.988033, 0.970012, 0.727077), (0.987691, 0.977154, 0.734536), (0.987387, 0.984288, 0.742002),
    (0.987053, 0.991438, 0.749504),
])


class Visualizer:
    def __init__(self, loss_weights_dict, dump_dir: str | None = None):
        self.loss_weights_dict = loss_weights_dict
        self.dump_dir = dump_dir
        self.log_list = []

    def add_log_pack(self, log_pack):
        self.log_list.append(log_pack)

    def dump_log(self, fname: str | None = None):
        fname = fname or self.dump_dir
        with open(fname, "wb") as f:
            pickle.dump(self.log_list, f)

    def print_loss(self, loss_pack, iter_=None):
        vals = {k: float(np.mean(np.asarray(v))) for k, v in loss_pack.items()}
        line = (
            "iter: {it}, loss_pixel: {loss_pixel:.6f}, loss_ssim: {loss_ssim:.6f}, "
            "loss_flow_smooth: {loss_flow_smooth:.6f}, "
            "loss_flow_consis: {loss_flow_consis:.6f}".format(
                it=iter_, **{k: vals.get(k, float("nan")) for k in _LOSSES})
        )
        # other values (e.g. snippets_per_sec) follow the reference's four,
        # so the log prefix stays grep-stable
        for k in sorted(vals):
            if k not in _LOSSES:
                line += f", {k}: {vals[k]:.6f}"
        print(line)


def _magma_rgb(disp: np.ndarray) -> np.ndarray:
    """(H, W) disparity -> (H, W, 3) uint8 RGB in the magma colormap,
    normalised from its minimum to its 95th percentile, as the JAX
    package's ``ScalarMappable(Normalize(min, p95), "magma").to_rgba``
    times 255, truncated."""
    disp = np.asarray(disp, dtype=np.float64)
    vmin, vmax = float(disp.min()), float(np.percentile(disp, 95))
    x = np.zeros_like(disp) if vmin == vmax else (disp - vmin) / (vmax - vmin)
    xa = x * 256
    xa[xa == 256] = 255  # 1.0 is the last colour, not "over"
    idx = np.zeros(xa.shape, np.int64)  # under: the first colour
    inside = (xa >= 0) & (xa < 256)
    idx[inside] = xa[inside].astype(np.int64)
    idx[xa >= 256] = 255  # over: the last colour
    rgb = _MAGMA[idx] * 255
    rgb[np.isnan(xa)] = 0  # matplotlib's "bad" colour: transparent black
    return rgb.astype(np.uint8)


class VisualizerDebug:
    """The JAX package's debug-image dumper: its image writers, drawing
    tools and 3-D ray plots."""

    # the correspondences' colours, BGR, taken in turn
    _COLORS = (
        (0, 0, 255), (0, 255, 0), (255, 0, 0), (0, 255, 255),
        (255, 0, 255), (255, 255, 0), (128, 0, 255), (0, 128, 255),
    )

    def __init__(self, dump_dir: str | None = None):
        self.dump_dir = dump_dir
        if dump_dir:
            os.makedirs(dump_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.dump_dir, name + ".png")

    @staticmethod
    def _write(path: str, img) -> str:
        img = np.asarray(img)
        if img.dtype not in (np.uint8, np.uint16):
            img = imageio.saturate_u8(img)  # as cv2.imwrite stores a float image
        imageio.imwrite(path, img)
        return path

    def save_img(self, img, name: str) -> str:
        """``<dump_dir>/<name>.png``: (H, W[, 1]) grey or BGR(A)."""
        return self._write(self._path(name), img)

    def show_mask(self, mask, name: str) -> str:
        """``<dump_dir>/<name>.png``: the mask scaled so its maximum is 255."""
        mask = np.asarray(mask, dtype=np.float64)
        return self._write(self._path(name), mask / max(mask.max(), 1e-12) * 255.0)

    def save_depth_img(self, depth, name: str) -> str:
        """``<dump_dir>/<name>_depth.png``: the depth stretched to 0..255."""
        depth = np.asarray(depth, dtype=np.float64)
        dmin, dmax = depth.min(), depth.max()
        norm = (depth - dmin) / max(dmax - dmin, 1e-12) * 255.0
        return self._write(self._path(name + "_depth"), norm.astype(np.uint8))

    def save_disp_color_img(self, disp, name: str) -> str:
        """``<dump_dir>/<name>_depth.jpg``: the disparity in magma, written
        as the JAX package's PIL writes it (``imageio.encode_jpeg``: the
        same bytes)."""
        path = os.path.join(self.dump_dir, name + "_depth.jpg")
        with open(path, "wb") as f:
            f.write(imageio.encode_jpeg(_magma_rgb(disp)[:, :, ::-1]))
        return path

    def save_flow_img(self, flow, name: str) -> str:
        """``<dump_dir>/<name>_flow.png``: the colour wheel of an (H, W, 2) flow."""
        return self._write(self._path(name + "_flow"), flow_to_image(np.asarray(flow)))

    # -- correspondences and epipolar lines ---------------------------------

    def show_corres(self, img1, img2, match, name: str) -> tuple[str, str]:
        """``<name>_img1_cor.png`` and ``<name>_img2_cor.png``: each image
        with its matched points, (4, N) rows [x1, y1, x2, y2], as circles of
        radius 1 and thickness 2 in the colours taken in turn."""
        match = np.asarray(match)
        paths = []
        for k, img in ((0, img1), (2, img2)):
            canvas = np.asarray(img, np.uint8).copy()  # never draw in place
            for i in range(match.shape[1]):
                x, y = int(round(match[k, i])), int(round(match[k + 1, i]))
                drawing.circle(canvas, (x, y), 1, self._COLORS[i % len(self._COLORS)], 2)
            paths.append(self._write(self._path(f"{name}_img{k // 2 + 1}_cor"), canvas))
        return paths[0], paths[1]

    def draw_point_corres(self, img1, img2, match, name: str) -> tuple[str, str]:
        paths = self.show_corres(img1, img2, match, name)
        print("Correspondence Saved in " + paths[0])
        return paths

    @staticmethod
    def drawlines(img1, img2, lines, pts1, pts2, rng=None):
        """Copies of both images: on the first each line (a, b, c), ax + by
        + c = 0, from x = 0 to its width, and its point as a filled circle of
        radius 3; on the second the other point.  Each pair's colour is drawn
        from ``rng`` (``np.random`` by default), as the JAX package draws it."""
        rng = rng or np.random
        img1 = np.asarray(img1, np.uint8).copy()  # never draw in place
        img2 = np.asarray(img2, np.uint8).copy()
        _, c = img1.shape[:2]
        for line, pt1, pt2 in zip(lines, pts1, pts2):
            color = tuple(int(v) for v in rng.randint(0, 255, 3))
            a, b, cc = line
            if abs(b) < 1e-12:
                continue
            x0, y0 = 0, int(-cc / b)
            x1, y1 = c, int(-(cc + a * c) / b)
            drawing.line(img1, (x0, y0), (x1, y1), color, 1)
            drawing.circle(img1, tuple(int(v) for v in pt1), 3, color, -1)
            drawing.circle(img2, tuple(int(v) for v in pt2), 3, color, -1)
        return img1, img2

    def show_epipolar_line(self, img1, img2, match, fundamental, name: str,
                           convention: str = "x2Fx1") -> tuple[str, str]:
        """``<name>_1eline.png`` and ``<name>_2eline.png``: each image with
        the epipolar lines the other image's points give under F (``"x2Fx1"``:
        x2^T F x1 = 0; ``"x1Fx2"``, as ``ops.geometry.fundamental_from_pose``
        returns it, is transposed first)."""
        if convention not in ("x2Fx1", "x1Fx2"):
            raise ValueError(f"unknown F convention: {convention!r}")
        match = np.asarray(match, np.float32)
        f = np.asarray(fundamental, np.float64)
        if convention == "x1Fx2":
            f = f.T
        pts1, pts2 = match[:2].T, match[2:].T
        out1, _ = self.drawlines(img1, img2, drawing.epilines(pts2, 2, f), pts1, pts2)
        out2, _ = self.drawlines(img2, img1, drawing.epilines(pts1, 1, f), pts2, pts1)
        return (self._write(self._path(name + "_1eline"), out1),
                self._write(self._path(name + "_2eline"), out2))

    def draw_epipolar_line(self, img1, img2, match, fundamental, name: str) -> tuple[str, str]:
        paths = self.show_epipolar_line(img1, img2, match, fundamental, name)
        print("Epipolar Lines Saved in " + paths[0])
        return paths

    # -- 3-D rays on any ax with plot3D and scatter ----------------------------

    @staticmethod
    def visualize_points(ax, points):
        ax.plot3D(points[:, 0], points[:, 1], points[:, 2])

    @staticmethod
    def scatter_3d(ax, point, scatter_color="r"):
        ax.scatter(point[0], point[1], point[2], c=scatter_color)

    def show_ray(self, ax, intrinsics, extrinsics, point2d):
        """Plot the camera ray through a pixel; returns its direction."""
        k_inv = np.linalg.inv(intrinsics)
        rot, t = extrinsics[:, :3], extrinsics[:, 3]
        direction = rot.T @ k_inv @ np.array([point2d[0], point2d[1], 1.0])
        direction = direction / (np.linalg.norm(direction) + 1e-12)
        origin = -rot.T @ t
        pts = origin[None] + np.linspace(0.0, 100.0, 1000)[:, None] * direction[None]
        self.visualize_points(ax, pts)
        self.scatter_3d(ax, pts[0], scatter_color="r")
        return direction

    def visualize_two_rays(self, ax, match, proj1, proj2):
        """Plot the two rays of a correspondence (proj1 = [K | 0]); returns
        their directions' dot product."""
        intrinsics = proj1[:, :3]
        k_inv = np.linalg.inv(intrinsics)
        rt1, rt2 = k_inv @ proj1, k_inv @ proj2
        x1, y1, x2, y2 = np.asarray(match, np.float64)
        d1 = self.show_ray(ax, intrinsics, rt1, [x1, y1])
        d2 = self.show_ray(ax, intrinsics, rt2, [x2, y2])
        return float(np.dot(d1.squeeze(), d2.squeeze()))
