"""Param system mirroring ``pyspark.ml.param`` semantics.

Implements the two-tier config contract SURVEY.md §5.6 identifies:
typed ``Param`` descriptors with doc-carried semantics (reference
``xgboost.py:38-106``), default maps vs user-set maps, and param
discovery via the ``params`` property ("entries with `Param(parent=...`",
reference ``xgboost.py:304-305``).

Counterpart of ``sparkdl_tpu/ml/param.py``, copied so that the port
imports nothing of the JAX package.
"""

import copy
import uuid


class Param:
    def __init__(self, parent, name, doc, typeConverter=None):
        self.parent = parent.uid if isinstance(parent, Params) else parent
        self.name = name
        self.doc = doc
        self.typeConverter = typeConverter or (lambda v: v)

    def __repr__(self):
        return f"{self.parent}__{self.name}"

    def __hash__(self):
        return hash(repr(self))

    def __eq__(self, other):
        return isinstance(other, Param) and repr(self) == repr(other)


class TypeConverters:
    @staticmethod
    def toInt(value):
        if isinstance(value, bool):
            raise TypeError(f"Could not convert {value!r} to int")
        return int(value)

    @staticmethod
    def toFloat(value):
        return float(value)

    @staticmethod
    def toBoolean(value):
        if isinstance(value, bool):
            return value
        raise TypeError(f"Boolean Param requires value of type bool, got {value!r}")

    @staticmethod
    def toString(value):
        return str(value)

    @staticmethod
    def toList(value):
        return list(value)

    @staticmethod
    def toListFloat(value):
        return [float(v) for v in value]

    @staticmethod
    def toListInt(value):
        return [int(v) for v in value]

    @staticmethod
    def toListString(value):
        return [str(v) for v in value]

    @staticmethod
    def identity(value):
        return value


class Params:
    """Mixin holding a param map + default map, pyspark-style."""

    def __init__(self):
        self._paramMap = {}
        self._defaultParamMap = {}
        self.uid = f"{type(self).__name__}_{uuid.uuid4().hex[:12]}"
        self._copy_class_params()

    @staticmethod
    def _dummy():
        d = object.__new__(Params)
        d.uid = "undefined"
        return d

    def _copy_class_params(self):
        """Rebind class-level Param descriptors to this instance (so
        ``est.maxDepth.parent == est.uid``, as in pyspark)."""
        for name in dir(type(self)):
            p = getattr(type(self), name, None)
            if isinstance(p, Param):
                inst = Param(self, p.name, p.doc, p.typeConverter)
                setattr(self, name, inst)

    @property
    def params(self):
        seen = {}
        for name in dir(self):
            if name == "params":
                continue
            p = self.__dict__.get(name)
            if isinstance(p, Param):
                seen[p.name] = p
        return [seen[k] for k in sorted(seen)]

    def getParam(self, paramName):
        p = getattr(self, paramName, None)
        if isinstance(p, Param):
            return p
        raise ValueError(f"Cannot find param with name: {paramName}")

    def hasParam(self, paramName):
        p = getattr(self, paramName, None)
        return isinstance(p, Param)

    def _resolveParam(self, param):
        return self.getParam(param) if isinstance(param, str) else param

    def isSet(self, param):
        return self._resolveParam(param) in self._paramMap

    def hasDefault(self, param):
        return self._resolveParam(param) in self._defaultParamMap

    def isDefined(self, param):
        return self.isSet(param) or self.hasDefault(param)

    def get(self, param):
        return self.getOrDefault(param)

    def getOrDefault(self, param):
        param = self._resolveParam(param)
        if param in self._paramMap:
            return self._paramMap[param]
        return self._defaultParamMap[param]

    def set(self, param, value):
        param = self._resolveParam(param)
        self._paramMap[param] = param.typeConverter(value)
        return self

    def _set(self, **kwargs):
        for name, value in kwargs.items():
            self.set(self.getParam(name), value)
        return self

    def _setDefault(self, **kwargs):
        for name, value in kwargs.items():
            p = self.getParam(name)
            self._defaultParamMap[p] = (
                value if value is None else p.typeConverter(value)
            )
        return self

    def clear(self, param):
        self._paramMap.pop(self._resolveParam(param), None)
        return self

    def extractParamMap(self, extra=None):
        pm = dict(self._defaultParamMap)
        pm.update(self._paramMap)
        if extra:
            pm.update(extra)
        return pm

    def explainParam(self, param):
        param = self._resolveParam(param)
        value = "undefined"
        if self.isDefined(param):
            value = self.getOrDefault(param)
        return f"{param.name}: {param.doc} (current: {value})"

    def explainParams(self):
        return "\n".join(self.explainParam(p) for p in self.params)

    def copy(self, extra=None):
        that = copy.copy(self)
        that._paramMap = dict(self._paramMap)
        that._defaultParamMap = dict(self._defaultParamMap)
        if extra:
            for param, value in extra.items():
                name = param.name if isinstance(param, Param) else param
                # extra maps may carry params for OTHER instances (e.g.
                # a Pipeline distributing a grid to its stages): apply
                # only the ones this instance owns.
                if that.hasParam(name):
                    that._paramMap[that.getParam(name)] = value
        return that

    def _copyValues(self, to, extra=None):
        pm = self.extractParamMap(extra)
        for p, v in pm.items():
            if to.hasParam(p.name):
                to._paramMap[to.getParam(p.name)] = v
        return to
