"""Persistence mixins mirroring ``pyspark.ml.util`` (reference
``xgboost.py:35``): ``MLWritable.write().save(path)`` /
``MLReadable.read().load(path)``, plus the ``save``/``load``
conveniences. Param values are stored as JSON; non-JSON values
(callbacks) go through cloudpickle with the reference's caveat that
they "may fail to load with different versions of dependencies"
(reference ``xgboost.py:49-56``).

Counterpart of ``sparkdl_tpu/ml/util.py``, copied so that the port
imports nothing of the JAX package.
"""

import base64
import json
import os
import shutil

from sparkdl_tpu_torch.ml.param import Param


class MLWriter:
    def __init__(self, instance):
        self.instance = instance
        self._overwrite = False

    def overwrite(self):
        self._overwrite = True
        return self

    def save(self, path):
        if os.path.exists(path):
            if not self._overwrite:
                raise IOError(
                    f"Path {path} already exists; call .write().overwrite()"
                    ".save(path) to overwrite."
                )
            shutil.rmtree(path)
        os.makedirs(path)
        self.instance._save_impl(path)


class MLReader:
    def __init__(self, cls):
        self.cls = cls

    def load(self, path):
        return self.cls._load_impl(path)


class MLWritable:
    def write(self):
        return MLWriter(self)

    def save(self, path):
        self.write().save(path)


class MLReadable:
    @classmethod
    def read(cls):
        return MLReader(cls)

    @classmethod
    def load(cls, path):
        return cls.read().load(path)


def params_to_json(instance):
    """Serialize an instance's user-set + default params."""
    import cloudpickle

    def enc(v):
        try:
            json.dumps(v)
            return {"json": v}
        except (TypeError, ValueError):
            return {
                "pickle": base64.b64encode(cloudpickle.dumps(v)).decode()
            }

    return {
        "uid": instance.uid,
        "set": {
            p.name: enc(v) for p, v in instance._paramMap.items()
        },
        "default": {
            p.name: enc(v) for p, v in instance._defaultParamMap.items()
        },
    }


def params_from_json(instance, payload):
    import cloudpickle

    def dec(d):
        if "json" in d:
            return d["json"]
        return cloudpickle.loads(base64.b64decode(d["pickle"]))

    for name, v in payload.get("default", {}).items():
        if instance.hasParam(name):
            instance._defaultParamMap[instance.getParam(name)] = dec(v)
    for name, v in payload.get("set", {}).items():
        if instance.hasParam(name):
            instance._paramMap[instance.getParam(name)] = dec(v)
    return instance
