"""OpenAPI 3.1 document of the serving surface and its ``/docs`` page.

Counterpart of ``hhrs_tpu/serve/openapi.py``. The JAX package derives the
component schemas from its pydantic models; the port keeps them as data,
equal to those (``tests/test_torch_port_http.py`` holds ``openapi_json``
and ``DOCS_HTML`` equal to the JAX package's). Served at
``GET /openapi.json``; ``GET /docs`` renders it with a self-contained HTML
explorer (no CDN asset) with try-it-out forms.
"""

from __future__ import annotations

import json

from hhrs_tpu_torch.serve.schemas import HTTP_BATCH_PAD

_REF_TEMPLATE = "#/components/schemas/{model}"

# pydantic's model_json_schema of the JAX package's request and response
# models, with refs under #/components/schemas.
COMPONENT_SCHEMAS = {
    "RecommendationRequest": {
        "properties": {
            "user_id": {
                "description": "ID of the user for personalization",
                "examples": [
                    15
                ],
                "title": "User Id",
                "type": "integer"
            },
            "city": {
                "description": "The city where hotels are being searched",
                "examples": [
                    "Sochi"
                ],
                "title": "City",
                "type": "string"
            },
            "type": {
                "default": "friends",
                "description": "Type of recommendations: 'friends' or 'personal'",
                "examples": [
                    "personal"
                ],
                "title": "Type",
                "type": "string"
            },
            "lambda_param": {
                "default": 0.7,
                "description": "MMR parameter (0.0 = max diversity, 1.0 = max accuracy)",
                "maximum": 1.0,
                "minimum": 0.0,
                "title": "Lambda Param",
                "type": "number"
            }
        },
        "required": [
            "user_id",
            "city"
        ],
        "title": "RecommendationRequest",
        "type": "object"
    },
    "HotelResponse": {
        "properties": {
            "hotel_id": {
                "title": "Hotel Id",
                "type": "integer"
            },
            "city": {
                "anyOf": [
                    {
                        "type": "string"
                    },
                    {
                        "type": "null"
                    }
                ],
                "default": None,
                "title": "City"
            },
            "price_rub": {
                "anyOf": [
                    {
                        "type": "number"
                    },
                    {
                        "type": "null"
                    }
                ],
                "default": None,
                "title": "Price Rub"
            },
            "stars": {
                "anyOf": [
                    {
                        "type": "number"
                    },
                    {
                        "type": "null"
                    }
                ],
                "default": None,
                "title": "Stars"
            },
            "recommended_by": {
                "default": [],
                "items": {
                    "type": "integer"
                },
                "title": "Recommended By",
                "type": "array"
            }
        },
        "required": [
            "hotel_id"
        ],
        "title": "HotelResponse",
        "type": "object"
    },
    "RecommendationResponse": {
        "properties": {
            "ranked_hotels": {
                "items": {
                    "$ref": "#/components/schemas/HotelResponse"
                },
                "title": "Ranked Hotels",
                "type": "array"
            },
            "message": {
                "anyOf": [
                    {
                        "type": "string"
                    },
                    {
                        "type": "null"
                    }
                ],
                "default": None,
                "title": "Message"
            }
        },
        "required": [
            "ranked_hotels"
        ],
        "title": "RecommendationResponse",
        "type": "object"
    },
    "BatchRecommendationRequest": {
        "description": "POST /recommendations/batch: up to HTTP_BATCH_PAD requests scored as\nONE padded device program (beyond the reference's contract).",
        "properties": {
            "requests": {
                "items": {
                    "$ref": "#/components/schemas/RecommendationRequest"
                },
                "maxItems": 64,
                "minItems": 1,
                "title": "Requests",
                "type": "array"
            }
        },
        "required": [
            "requests"
        ],
        "title": "BatchRecommendationRequest",
        "type": "object"
    },
    "BatchRecommendationResponse": {
        "properties": {
            "responses": {
                "items": {
                    "$ref": "#/components/schemas/RecommendationResponse"
                },
                "title": "Responses",
                "type": "array"
            }
        },
        "required": [
            "responses"
        ],
        "title": "BatchRecommendationResponse",
        "type": "object"
    },
    "SimilarItemsResponse": {
        "properties": {
            "similar_item_ids": {
                "items": {
                    "type": "integer"
                },
                "title": "Similar Item Ids",
                "type": "array"
            }
        },
        "required": [
            "similar_item_ids"
        ],
        "title": "SimilarItemsResponse",
        "type": "object"
    },
    "ErrorResponse": {
        "description": "404/405/422/500 body shape (FastAPI-compatible ``detail``; 422\ndetail may be a string or the validator's structured error list).",
        "properties": {
            "detail": {
                "title": "Detail"
            }
        },
        "required": [
            "detail"
        ],
        "title": "ErrorResponse",
        "type": "object"
    }
}


def _err(description: str) -> dict:
    return {
        "description": description,
        "content": {"application/json": {"schema": {"$ref": _REF_TEMPLATE.format(model="ErrorResponse")}}},
    }


def build_openapi_spec(batch_pad: int = HTTP_BATCH_PAD) -> dict:
    """The complete OpenAPI 3.1 document for the serve surface."""
    components = json.loads(json.dumps(COMPONENT_SCHEMAS))  # a copy the caller may change
    refs = {name: {"$ref": _REF_TEMPLATE.format(model=name)} for name in components}

    paths = {
        "/recommendations": {
            "post": {
                "summary": "Two-stage personalized hotel recommendations",
                "description": (
                    "Stage 1: hybrid candidate generation (friend ratings / "
                    "own history, kNN expansion, popularity fallback). "
                    "Stage 2: DCN-R ranking; lambda_param < 1.0 applies MMR "
                    "diversification (top 20)."
                ),
                "operationId": "get_recommendations",
                "requestBody": {
                    "required": True,
                    "content": {"application/json": {"schema": refs["RecommendationRequest"]}},
                },
                "responses": {
                    "200": {
                        "description": "Ranked hotels (possibly empty, with a message)",
                        "content": {"application/json": {"schema": refs["RecommendationResponse"]}},
                    },
                    "422": _err("Request validation failed"),
                    "500": _err("Internal server error"),
                },
            }
        },
        "/recommendations/batch": {
            "post": {
                "summary": f"Batch recommendations (1..{batch_pad} requests, one device program)",
                "operationId": "get_recommendations_batch",
                "requestBody": {
                    "required": True,
                    "content": {"application/json": {"schema": refs["BatchRecommendationRequest"]}},
                },
                "responses": {
                    "200": {
                        "description": "One response per request, in order",
                        "content": {"application/json": {"schema": refs["BatchRecommendationResponse"]}},
                    },
                    "422": _err("Request validation failed or too many items"),
                    "500": _err("Internal server error"),
                },
            }
        },
        "/similar_items": {
            "get": {
                "summary": "Nearest items by embedding cosine similarity",
                "operationId": "get_similar_items",
                "parameters": [
                    {"name": "item_id", "in": "query", "required": True,
                     "schema": {"type": "integer"}},
                    {"name": "n", "in": "query", "required": False,
                     "schema": {"type": "integer", "minimum": 1, "maximum": 50,
                                "default": 10}},
                ],
                "responses": {
                    "200": {
                        "description": "Similar item ids (self excluded)",
                        "content": {"application/json": {"schema": refs["SimilarItemsResponse"]}},
                    },
                    "404": _err("Unknown item id"),
                    "422": _err("Invalid query parameters"),
                    "500": _err("Internal server error"),
                },
            }
        },
        "/healthz": {
            "get": {
                "summary": "Liveness, active model, latency summary, wrapper stats",
                "operationId": "healthz",
                "responses": {
                    "200": {
                        "description": "Service health",
                        "content": {"application/json": {"schema": {
                            "type": "object",
                            "properties": {
                                "status": {"type": "string"},
                                "model": {"type": ["string", "null"]},
                                "latency": {"type": "object"},
                                # present when hot reload is on (model or
                                # data poller): swaps served so far
                                "hot_swaps": {"type": "integer"},
                            },
                            "required": ["status"],
                            "additionalProperties": True,
                        }}},
                    }
                },
            }
        },
        "/metrics": {
            "get": {
                "summary": "Prometheus text exposition",
                "operationId": "metrics",
                "responses": {
                    "200": {"description": "Metrics",
                            "content": {"text/plain": {"schema": {"type": "string"}}}}
                },
            }
        },
    }

    return {
        "openapi": "3.1.0",
        "info": {
            "title": "Hybrid Recommendation API (TPU-native)",
            "version": "1.0",
            "description": (
                "Two-stage hotel recommender: social-graph candidate "
                "generation + DCN-R ranking with MMR diversification. "
                "Same REST contract as the reference service."
            ),
            "license": {"name": "MIT"},
        },
        "paths": paths,
        "components": {"schemas": components},
    }


def openapi_json(batch_pad: int = HTTP_BATCH_PAD) -> str:
    return json.dumps(build_openapi_spec(batch_pad))


# Self-contained interactive explorer: renders /openapi.json with vanilla
# JS (operation list, expandable schemas, try-it-out forms that really call
# the API) — no CDN assets, so /docs works in air-gapped deployments where
# swagger-ui's external bundles would not load.
DOCS_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>Hybrid Recommendation API — docs</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#f7f7f9;color:#1a1a24}
 header{background:#1a1a2e;color:#fff;padding:14px 24px}
 header h1{font-size:18px;margin:0}
 header p{margin:4px 0 0;color:#b8b8d0;font-size:13px}
 main{max-width:980px;margin:18px auto;padding:0 16px}
 .op{background:#fff;border:1px solid #ddd;border-radius:6px;margin:10px 0;overflow:hidden}
 .op>summary{padding:10px 14px;cursor:pointer;display:flex;gap:12px;align-items:center}
 .op>summary::-webkit-details-marker{display:none}
 .method{font-weight:700;font-size:12px;padding:3px 10px;border-radius:4px;color:#fff;min-width:44px;text-align:center}
 .get{background:#2f7d32}.post{background:#1565c0}
 .path{font-family:ui-monospace,monospace;font-size:14px}
 .sum{color:#666;font-size:13px}
 .body{padding:6px 16px 14px;border-top:1px solid #eee}
 pre{background:#f0f0f4;padding:10px;border-radius:4px;overflow:auto;font-size:12px}
 textarea{width:100%;min-height:90px;font-family:ui-monospace,monospace;font-size:12px;box-sizing:border-box}
 input{font-family:ui-monospace,monospace;font-size:12px;padding:3px}
 button{background:#1a1a2e;color:#fff;border:0;border-radius:4px;padding:6px 14px;cursor:pointer;margin:6px 0}
 .resp{white-space:pre-wrap}
 h4{margin:12px 0 4px;font-size:13px;text-transform:uppercase;letter-spacing:.04em;color:#555}
 .code{font-family:ui-monospace,monospace}
</style></head><body>
<header><h1 id="t">Hybrid Recommendation API</h1><p id="d"></p>
<p>raw spec: <a href="/openapi.json" style="color:#9fc2ff">/openapi.json</a></p></header>
<main id="ops"></main>
<script>
function deref(s,spec){if(s&&s.$ref){const p=s.$ref.split('/').pop();return deref(spec.components.schemas[p],spec)}return s}
function schemaStr(s,spec,ind){ind=ind||0;s=deref(s,spec);if(!s)return'any';
 const pad='  '.repeat(ind+1),pad0='  '.repeat(ind);
 if(s.type==='object'&&s.properties){const req=s.required||[];
  return '{\\n'+Object.entries(s.properties).map(([k,v])=>pad+k+(req.includes(k)?'':'?')+': '+schemaStr(v,spec,ind+1)).join(',\\n')+'\\n'+pad0+'}'}
 if(s.type==='array')return schemaStr(s.items,spec,ind)+'[]';
 if(s.anyOf)return s.anyOf.map(x=>schemaStr(x,spec,ind)).join(' | ');
 let t=Array.isArray(s.type)?s.type.join('|'):(s.type||'any');
 if(s.minimum!==undefined||s.maximum!==undefined)t+=' ['+(s.minimum??'')+'..'+(s.maximum??'')+']';
 return t}
function exampleOf(s,spec){s=deref(s,spec);if(!s)return null;
 if(s.examples&&s.examples.length)return s.examples[0];
 if(s.default!==undefined)return s.default;
 if(s.type==='object'&&s.properties){const o={};for(const[k,v]of Object.entries(s.properties))o[k]=exampleOf(v,spec);return o}
 if(s.type==='array')return[exampleOf(s.items,spec)];
 if(s.anyOf)return exampleOf(s.anyOf[0],spec);
 if(s.type==='integer'||s.type==='number')return 0;
 if(s.type==='string')return'string';if(s.type==='boolean')return false;return null}
fetch('/openapi.json').then(r=>r.json()).then(spec=>{
 document.getElementById('t').textContent=spec.info.title+' — v'+spec.info.version;
 document.getElementById('d').textContent=spec.info.description||'';
 const main=document.getElementById('ops');
 for(const[path,methods]of Object.entries(spec.paths)){
  for(const[method,op]of Object.entries(methods)){
   const det=document.createElement('details');det.className='op';
   let inner='<summary><span class="method '+method+'">'+method.toUpperCase()+
    '</span><span class="path">'+path+'</span><span class="sum">'+(op.summary||'')+'</span></summary>';
   let body='<div class="body">';
   if(op.description)body+='<p>'+op.description+'</p>';
   if(op.parameters&&op.parameters.length){body+='<h4>Query parameters</h4><pre>'+
    op.parameters.map(p=>p.name+(p.required?'':'?')+': '+schemaStr(p.schema,spec)).join('\\n')+'</pre>'}
   if(op.requestBody){const rs=op.requestBody.content['application/json'].schema;
    body+='<h4>Request body</h4><pre>'+schemaStr(rs,spec)+'</pre>'}
   for(const[code,resp]of Object.entries(op.responses)){
    const c=resp.content&&(resp.content['application/json']||resp.content['text/plain']);
    body+='<h4>Response '+code+'</h4><p class="sum">'+(resp.description||'')+'</p>';
    if(c)body+='<pre>'+schemaStr(c.schema,spec)+'</pre>'}
   body+='<h4>Try it</h4>';
   const fid=(method+path).replace(/[^a-z0-9]/gi,'_');
   if(method==='post'){const rs=op.requestBody.content['application/json'].schema;
    body+='<textarea id="in_'+fid+'">'+JSON.stringify(exampleOf(rs,spec),null,1)+'</textarea>'}
   else if(op.parameters&&op.parameters.length){
    body+=op.parameters.map(p=>'<label class="code">'+p.name+' <input id="q_'+fid+'_'+p.name+
     '" value="'+(exampleOf(p.schema,spec)??'')+'"></label> ').join('')}
   body+='<br><button onclick="go(\\''+method+'\\',\\''+path+'\\',\\''+fid+'\\')">Send</button>'+
    '<pre class="resp" id="out_'+fid+'"></pre></div>';
   det.innerHTML=inner+body;main.appendChild(det);
  }}
 window._spec=spec});
function go(method,path,fid){
 const out=document.getElementById('out_'+fid);out.textContent='...';
 let url=path,opts={method:method.toUpperCase()};
 if(method==='post'){opts.headers={'content-type':'application/json'};
  opts.body=document.getElementById('in_'+fid).value}
 else{const qs=[...document.querySelectorAll('[id^="q_'+fid+'_"]')]
  .filter(i=>i.value!=='').map(i=>i.id.slice(('q_'+fid+'_').length)+'='+encodeURIComponent(i.value));
  if(qs.length)url+='?'+qs.join('&')}
 fetch(url,opts).then(async r=>{const t=await r.text();
  out.textContent='HTTP '+r.status+'\\n'+t}).catch(e=>out.textContent=String(e))}
</script></body></html>"""
