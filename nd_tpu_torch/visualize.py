"""Quick visualization: RGB export, video writing, cartographic maps.

Counterpart of ``nd_tpu/visualize.py`` (``colorize``, ``to_rgb``,
``write_video``, ``plot_map``). :func:`to_rgb` does its arithmetic on
the data's device: the percentile limits (``core.nanops.nanquantile``,
numpy's ``linear`` rule), the float64 stretch to [0, 255], the uint8
cast, the colormap (OpenCV's lookup table, read once from cv2 and
indexed on the device) and the mask. Only the (h, w, 3) uint8 image
crosses to the host, where cv2 resizes and writes it; the image equals
the JAX package's bit for bit. numpy input stays on the host (its
device is the CPU).

cv2 and imageio are optional and imported where they are used: without
cv2 the image functions raise ImportError ("this function requires
opencv-python (cv2)"), without imageio :func:`write_video` does.
``plot_map`` draws on a cartopy axis where cartopy imports and otherwise
renders with :func:`nd_tpu_torch.visualize_map.render_map`;
``gridlines_with_labels`` and ``scale_bar`` need cartopy.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .core import DataArray
from .core.nanops import nanquantile
from .utils import requires

try:
    import cartopy
except ImportError:
    cartopy = None

__all__ = ['colorize', 'to_rgb', 'write_video', 'plot_map',
           'render_map', 'gridlines_with_labels', 'scale_bar',
           'calculate_shape', 'CMAPS']

from .visualize_map import render_map  # noqa: E402


def _cv2():
    try:
        import cv2
    except ImportError:
        raise ImportError('this function requires opencv-python (cv2)') \
            from None
    return cv2


def _discover_colormaps():
    """Lowercase name -> cv2 colormap id, for every COLORMAP_* the
    installed OpenCV ships (empty without cv2)."""
    try:
        import cv2
    except ImportError:
        return {}
    tag = 'COLORMAP_'
    return {name[len(tag):].lower(): value
            for name, value in vars(cv2).items()
            if name.startswith(tag) and isinstance(value, int)}


CMAPS = _discover_colormaps()


def _parse_cmap(cmap):
    # a known name resolves to its cv2 id; anything else (an id, a LUT
    # array) passes through untouched
    return CMAPS.get(str(cmap).lower(), cmap)


def _lut(cmap, device):
    """cv2's colormap ``cmap`` as a (256, 3) uint8 BGR table on
    ``device``: ``applyColorMap`` of a gray image is this lookup."""
    cv2 = _cv2()
    ramp = cv2.cvtColor(np.arange(256, dtype=np.uint8)[:, None],
                        cv2.COLOR_GRAY2BGR)
    table = cv2.applyColorMap(ramp, _parse_cmap(cmap))
    return torch.from_numpy(np.ascontiguousarray(table[:, 0])).to(device)


def calculate_shape(new_shape, orig_shape):
    """Fill in missing height/width, preserving the aspect ratio.

    Parameters
    ----------
    new_shape : tuple or None
        Desired (height, width); either entry may be None.
    orig_shape : tuple
        The original (height, width).

    Returns
    -------
    tuple of int
    """
    if new_shape is None:
        return orig_shape
    height, width = new_shape
    if height is None:
        if width is not None:
            height = width * orig_shape[0] / orig_shape[1]
            height = height // 2 * 2
        else:
            height = orig_shape[0]
            width = orig_shape[1]
    elif width is None:
        width = height * orig_shape[1] / orig_shape[0]
        width = width // 2 * 2
    return (int(height), int(width))


def _tensor(d):
    """A channel, mask or label image as a tensor: a DataArray's data, a
    tensor as it is, anything else through numpy onto the CPU."""
    if isinstance(d, DataArray):
        return d.data
    if isinstance(d, torch.Tensor):
        return d
    return torch.from_numpy(np.array(d))


def _gray_labels(labels, N):
    """colorize's gray levels: (labels % N) * 255 / (N - 1) as uint8."""
    if N is None:
        N = min(10, len(torch.unique(labels)))
    N = max(N, 2)
    return ((labels % N).to(torch.float64) * (255 / (N - 1))) \
        .to(torch.uint8)


def colorize(labels, N=None, nan_vals=[], cmap='jet'):
    """Apply a colormap to an integer label image -> BGR image (numpy
    uint8); the levels and the lookup are computed on the labels'
    device."""
    labels = _tensor(labels)
    lut = _lut(cmap, labels.device)
    colored = lut[_gray_labels(labels, N).long()]
    for nv in nan_vals:
        colored[labels == nv] = 0
    return colored.cpu().numpy()


def _stretch(channels, vmin=None, vmax=None, pmin=2, pmax=98):
    """to_rgb's stretch on the channels' device: each 2-d channel in
    float64 from [vmin, vmax] (or its ``pmin``/``pmax`` percentiles) to
    [0, 255], NaN to 0, clipped, truncated to uint8 -> (h, w, n) uint8.
    A channel whose limits are not increasing is cast as it is."""
    n = len(channels)
    if isinstance(vmin, (int, float)):
        vmin = [vmin] * n
    if isinstance(vmax, (int, float)):
        vmax = [vmax] * n
    planes = []
    for i, c in enumerate(channels):
        c = c.to(torch.float64)
        # q as numpy's nanpercentile forms it, p / 100 in float64; one
        # sort serves both percentiles
        lo, hi = nanquantile(c, [pmin / 100, pmax / 100]) \
            if vmin is None or vmax is None else (None, None)
        if vmin is not None:
            lo = torch.tensor(float(vmin[i]), dtype=torch.float64,
                              device=c.device)
        if vmax is not None:
            hi = torch.tensor(float(vmax[i]), dtype=torch.float64,
                              device=c.device)
        if bool(hi > lo):
            # a 0-dim device divisor: the card divides (a CPU scalar
            # would be multiplied by its reciprocal)
            c = (c - lo) / (hi - lo) * 255
        planes.append(c)
    im = torch.stack(planes, -1)
    return torch.nan_to_num(im).clamp_(0, 255).to(torch.uint8)


def _bgr(channels, vmin=None, vmax=None, pmin=2, pmax=98,
         categorical=False, mask=None, cmap=None):
    """to_rgb's image on the channels' device: (h, w, 3) uint8, BGR."""
    dev = channels[0].device
    if categorical:
        colored = _lut('jet', dev)[_gray_labels(channels[0], None).long()]
        colored[channels[0] == 0] = 0
    else:
        im = _stretch(channels, vmin, vmax, pmin, pmax)
        if len(channels) == 1:
            colored = im.expand(-1, -1, 3).contiguous() if cmap is None \
                else _lut(cmap, dev)[im[..., 0].long()]
        else:
            colored = im[..., [2, 1, 0]]        # RGB(A) -> BGR
    if mask is not None:
        colored[~_tensor(mask).to(dev, torch.bool)] = 0
    return colored


def to_rgb(data, output=None, vmin=None, vmax=None, pmin=2, pmax=98,
           categorical=False, mask=None, shape=None, cmap=None):
    """Convert data channels into an RGB image (or write it to a file).

    Parameters
    ----------
    data : DataArray, tensor, ndarray or list of them
        One (grayscale/colormapped) or three (RGB) 2-d channels. The
        arithmetic runs on their device.
    output : str, optional
        Output image path; if None the array is returned.
    vmin, vmax : float or list, optional
        Explicit stretch limits per channel.
    pmin, pmax : float, optional
        Percentile stretch when vmin/vmax are absent (default 2/98).
    categorical : bool, optional
        Colorize integer labels instead of stretching.
    mask : ndarray or tensor, optional
        Pixels outside the mask are blacked out.
    shape : tuple, optional
        Output (height, width); either may be None.
    cmap : optional
        OpenCV colormap for single-channel data.

    Returns
    -------
    np.ndarray (RGB) or None
    """
    cv2 = _cv2()
    if isinstance(data, list):
        channels = data
    elif isinstance(data, (DataArray, np.ndarray, torch.Tensor)):
        channels = [data]
    else:
        raise ValueError('`data` must be a DataArray or list of '
                         'DataArrays')
    channels = [_tensor(d) for d in channels]
    if any(c.ndim > 2 for c in channels):
        raise ValueError('The RGB channels must be two-dimensional.')

    colored = _bgr(channels, vmin, vmax, pmin, pmax, categorical, mask,
                   cmap).cpu().numpy()
    shape = calculate_shape(shape, colored.shape[:2])
    colored = cv2.resize(colored, shape[::-1])

    if output is None:
        return cv2.cvtColor(colored, cv2.COLOR_BGR2RGB)
    cv2.imwrite(output, colored)


def write_video(ds, path, timestamp='upper left', fontcolor=(0, 0, 0),
                width=None, height=None, fps=1, codec=None, rgb=None,
                cmap=None, mask=None, contours=None, **kwargs):
    """Render the time axis of a dataset as a video (or GIF).

    Parameters
    ----------
    ds : Dataset or DataArray with dims y, x, time.
    path : str
        Output video path (codec from extension; .gif supported).
    timestamp : str or None, optional
        Timestamp stamp corner ('upper left', 'lr', ... or None).
    fontcolor : tuple, optional
        Timestamp color (default black).
    width, height : int, optional
        Output size (default: dataset size, aspect preserved).
    fps : int, optional
        Frames per second (default 1).
    codec : str, optional
        fourcc codec for non-GIF output (default libx264).
    rgb : callable, optional
        Maps each time slice to RGB channels; default C11/C22/ratio
        for Datasets, grayscale for DataArrays.
    cmap, mask :
        Forwarded to :func:`to_rgb`.
    """
    cv2 = _cv2()
    import imageio
    if rgb is None:
        if isinstance(ds, DataArray):
            def rgb(d):
                return d
        else:
            def rgb(d):
                return [d['C11'], d['C22'], d['C11'] / d['C22']]

    height, width = calculate_shape(
        (height, width),
        (len(np.asarray(ds.coords['y'].values)),
         len(np.asarray(ds.coords['x'].values))))

    _, ext = os.path.splitext(path)
    writer_kwargs = {'mode': 'I', 'fps': fps}
    writer_kwargs.update(kwargs)
    if ext != '.gif':
        writer_kwargs['macro_block_size'] = None
        writer_kwargs['ffmpeg_log_level'] = 'error'
        writer_kwargs['codec'] = codec or 'libx264'

    font = cv2.FONT_HERSHEY_SIMPLEX
    font_scale, font_weight = 1, 2
    inset = 0.02   # stamp inset from the frame edge, fraction of size

    def _label(t):
        """Date label for one time coordinate value."""
        try:
            return np.datetime_as_string(np.datetime64(t, 'D'))
        except (ValueError, TypeError):
            return str(t)

    def _anchor(label):
        """Bottom-left text origin for the requested corner, derived
        from the rendered text extent."""
        (tw, th), _ = cv2.getTextSize(label, font, font_scale,
                                      font_weight)
        dx = int(round(width * inset))
        dy = int(round(height * inset))
        where = timestamp if isinstance(timestamp, str) else ''
        x = width - tw - dx if ('right' in where or where == 'ur'
                                or where == 'lr') else dx
        y = height - dy if ('lower' in where or where == 'll'
                            or where == 'lr') else th + dy
        return x, y

    overlay = None
    if contours is not None:
        overlay = dict(contours=contours, contourIdx=-1,
                       color=(255, 255, 255), thickness=1)

    with imageio.get_writer(path, **writer_kwargs) as writer:
        for t in np.asarray(ds.coords['time'].values):
            frame = to_rgb(rgb(ds.sel(time=t)), cmap=cmap, mask=mask)
            if overlay is not None:
                frame = cv2.drawContours(frame, **overlay)
            frame = cv2.resize(frame, (width, height))
            if timestamp not in (False, None):
                stamp = _label(t)
                cv2.putText(frame, stamp, _anchor(stamp), font,
                            font_scale, fontcolor, font_weight)
            writer.append_data(frame)


def plot_map(ds, buffer=None, background='_default', imscale=6,
             gridlines=True, coastlines=True, scalebar=True,
             gridlines_kwargs={}, output=None):
    """Plot a dataset's footprint on an orthographic basemap.

    ``buffer`` is the extra margin around the footprint relative to its
    size (default ~20% per side), ``background`` a
    ``cartopy.io.img_tiles`` tile source ('_default' tries Stamen
    terrain and degrades to no basemap when tiles are unavailable,
    e.g. offline), ``imscale`` the tile zoom level, ``scalebar`` adds
    a geodesic scale bar.

    With cartopy+matplotlib installed this returns a cartopy
    ``GeoAxes``. Without them it renders with
    :func:`nd_tpu_torch.visualize_map.render_map` (the same orthographic
    view, graticule labels and geodesic scale bar) and returns the RGB
    image instead; ``output`` then names an optional PNG path.
    """
    import warnings

    if cartopy is None:
        return render_map(ds, buffer=buffer, graticule=gridlines,
                          scalebar=scalebar, output=output)

    import matplotlib.pyplot as plt
    import cartopy.crs as ccrs
    from . import warp

    if background == '_default':
        try:
            import cartopy.io.img_tiles as cimgt
            background = cimgt.Stamen('terrain-background') \
                if hasattr(cimgt, 'Stamen') else cimgt.StamenTerrain()
        except Exception:
            background = None

    extent = warp.get_extent(ds)
    factor = 1.2 if buffer is None else 1.0 + buffer
    lon0 = (extent.left + extent.right) / 2
    lat0 = (extent.bottom + extent.top) / 2
    half_w = (extent.right - extent.left) / 2 * factor
    half_h = (extent.top - extent.bottom) / 2 * factor
    view = [max(lon0 - half_w, -180), min(lon0 + half_w, 180),
            max(lat0 - half_h, -90), min(lat0 + half_h, 90)]

    proj = ccrs.Orthographic(lon0, lat0)
    ax = plt.axes(projection=proj)
    ax.set_extent(view, crs=ccrs.PlateCarree())
    if background is not None:
        try:
            ax.add_image(background, imscale)
        except Exception as e:   # offline / tile service unavailable
            warnings.warn('background tiles unavailable (%s); '
                          'plotting without a basemap' % e)
            background = None
    if coastlines:
        ax.coastlines(resolution='10m',
                      color='black' if background is None else 'white')
    geom = warp.get_geometry(ds)
    xs = [c[0] for c in geom.exterior.coords]
    ys = [c[1] for c in geom.exterior.coords]
    ax.fill(xs, ys, transform=ccrs.PlateCarree(),
            facecolor=(1, 0, 0, 0.2), edgecolor=(0, 0, 0, 1))
    if scalebar:
        scale_bar(ax, (0.05, 0.05), None)
    if gridlines:
        color = '0.5' if background is None else 'white'
        gridlines_with_labels(ax, color=color, **gridlines_kwargs)
    if output is not None:
        plt.gcf().savefig(output, bbox_inches='tight')
    return ax


@requires('cartopy')
def gridlines_with_labels(ax, top=True, bottom=True, left=True,
                          right=True, **kwargs):
    """Draw gridlines with degree labels on a cartopy axis, including
    projections where cartopy cannot label automatically.

    Requires cartopy (optional dependency).
    """
    import cartopy.crs as ccrs
    import matplotlib.ticker as mticker

    # lon/lat range of the view: transform a boundary sampling
    x0, x1 = ax.get_xlim()
    y0, y1 = ax.get_ylim()
    pc = ccrs.PlateCarree()
    bx = np.linspace(x0, x1, 25)
    by = np.linspace(y0, y1, 25)
    pts = ([(x, y0) for x in bx] + [(x, y1) for x in bx]
           + [(x0, y) for y in by] + [(x1, y) for y in by])
    lonlats = np.array([pc.transform_point(px, py, ax.projection)
                        for px, py in pts])
    lonlats = lonlats[np.all(np.isfinite(lonlats), axis=1)]
    lon_lo, lon_hi = lonlats[:, 0].min(), lonlats[:, 0].max()
    lat_lo, lat_hi = lonlats[:, 1].min(), lonlats[:, 1].max()
    lon_ticks = mticker.MaxNLocator(8).tick_values(lon_lo, lon_hi)
    lat_ticks = mticker.MaxNLocator(8).tick_values(lat_lo, lat_hi)

    # gridlines at exactly the tick values the labels will name
    gl = ax.gridlines(draw_labels=False, **kwargs)
    gl.xlocator = mticker.FixedLocator(lon_ticks)
    gl.ylocator = mticker.FixedLocator(lat_ticks)

    def _lon_label(lon):
        return '%g°%s' % (abs(lon), 'E' if lon >= 0 else 'W')

    def _lat_label(lat):
        return '%g°%s' % (abs(lat), 'N' if lat >= 0 else 'S')

    # place each label where ITS graticule meets the axes edge (works
    # for arbitrary projections; unprojectable points are skipped)
    def _edge_labels(values, fixed, is_lon, enabled, offset, va, ha):
        if not enabled:
            return
        for v in values:
            lon, lat = (v, fixed) if is_lon else (fixed, v)
            try:
                px, py = ax.projection.transform_point(lon, lat, pc)
            except Exception:
                continue
            if not (np.isfinite(px) and np.isfinite(py)):
                continue
            if not (x0 - 1e-9 <= px <= x1 + 1e-9
                    and y0 - 1e-9 <= py <= y1 + 1e-9):
                continue
            ax.annotate(_lon_label(v) if is_lon else _lat_label(v),
                        xy=(px, py), xytext=offset,
                        textcoords='offset points', fontsize=8,
                        ha=ha, va=va)

    _edge_labels(lon_ticks, lat_lo, True, bottom, (0, -12),
                 'top', 'center')
    _edge_labels(lon_ticks, lat_hi, True, top, (0, 12),
                 'bottom', 'center')
    _edge_labels(lat_ticks, lon_lo, False, left, (-8, 0),
                 'center', 'right')
    _edge_labels(lat_ticks, lon_hi, False, right, (8, 0),
                 'center', 'left')
    return gl


@requires('cartopy')
def scale_bar(ax, location=(0.1, 0.05), length=None,
              metres_per_unit=1000, unit_name='km', color='black',
              linewidth=3, text_offset=0.01, ha='center', va='bottom',
              **kwargs):
    """Draw a geodesic scale bar on a cartopy axis.

    ``location`` is the bar's left end in axes coordinates and
    ``length`` its geodesic length in ``unit_name`` units (None picks a
    round number ~20% of the view width). The length is computed with
    the port's own geodesic math (no cartopy.geodesic needed). Requires
    cartopy for the axis.
    """
    import cartopy.crs as ccrs

    length_km = None if length is None \
        else float(length) * metres_per_unit / 1000.0
    x0, x1 = ax.get_xlim()
    y0, y1 = ax.get_ylim()
    sbx = x0 + (x1 - x0) * location[0]
    sby = y0 + (y1 - y0) * location[1]
    pc = ccrs.PlateCarree()
    lon0, lat0 = pc.transform_point(sbx, sby, ax.projection)
    lon1, lat1 = pc.transform_point(sbx + (x1 - x0) * 0.2, sby,
                                    ax.projection)
    # true ellipsoidal ground distance of 20% of the view width
    from .crs.geodesic import geodesic_inverse
    from .crs.proj import ELLIPSOIDS
    s, _, _ = geodesic_inverse(np.radians(lon0), np.radians(lat0),
                               np.radians(lon1), np.radians(lat1),
                               ELLIPSOIDS['WGS84'])
    span_km = float(s) / 1000.0
    if length_km is None:
        # round to a nice number
        mag = 10 ** np.floor(np.log10(max(span_km, 1e-6)))
        length_km = float(int(span_km / mag) * mag) or mag
    frac = length_km / span_km * 0.2
    ax.plot([sbx, sbx + (x1 - x0) * frac], [sby, sby],
            transform=ax.projection, color=color, linewidth=linewidth,
            **kwargs)
    label_units = length_km * 1000.0 / metres_per_unit
    ax.text(sbx + (x1 - x0) * frac / 2,
            sby + (y1 - y0) * text_offset,
            '%g %s' % (label_units, unit_name), ha=ha, va=va,
            fontsize=8, color=color)
    return length_km
