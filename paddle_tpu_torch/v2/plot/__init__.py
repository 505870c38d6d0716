"""Training-curve plotting (counterpart of paddle_tpu/v2/plot; reference
python/paddle/v2/plot/plot.py:32 Ploter). Uses matplotlib when importable
and a DISPLAY-less Agg backend, imported when a Ploter is made, never at
import; otherwise silently records values so training scripts run
anywhere."""

from __future__ import annotations

__all__ = ["Ploter"]


class PlotData(object):
    def __init__(self):
        self.step = []
        self.value = []

    def append(self, step, value):
        self.step.append(step)
        self.value.append(value)

    def reset(self):
        self.step = []
        self.value = []


class Ploter(object):
    def __init__(self, *args):
        self.__args__ = args
        self.__plot_data__ = {t: PlotData() for t in args}
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            self._plt = plt
        except Exception:
            self._plt = None

    def __getitem__(self, title):
        return self.__plot_data__[title]

    def append(self, title, step, value):
        self.__plot_data__[title].append(step, value)

    def plot(self, path=None):
        if self._plt is None:
            return
        self._plt.figure()
        for title in self.__args__:
            d = self.__plot_data__[title]
            if d.step:
                self._plt.plot(d.step, d.value, label=title)
        self._plt.legend()
        if path:
            self._plt.savefig(path)
        self._plt.close()

    def reset(self):
        for d in self.__plot_data__.values():
            d.reset()
