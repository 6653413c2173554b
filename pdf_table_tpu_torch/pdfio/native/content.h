// Content-stream interpreter: extracts positioned text runs, stroked /
// filled line segments and rectangles, and image placements from a page.
// Coordinates are PDF user space (origin bottom-left, y up), unrotated.
#pragma once

#include <string>
#include <vector>

#include "doc.h"
#include "fonts.h"

namespace pdfio {

struct TextRun {
  std::string utf8;
  double x0, y0, x1, y1;      // device-space bbox (pdf coords, y-up)
  double ox, oy;              // baseline origin of the run start
  double dx, dy;              // unit baseline direction in device space
  double size;                // font size in device units (|Trm| scaled)
  std::string font;
  std::vector<double> adv;    // per-char advance (device units along baseline)
  int rmode = 0;              // text render mode (3 = invisible)
};

struct SegItem {
  double x0, y0, x1, y1;
  double lw;        // line width (device units)
  int is_fill = 0;  // came from a fill op (thin filled rect)
};

struct RectItem {
  double x0, y0, x1, y1;
  double lw;
  int stroked = 0, filled = 0;
};

struct CurveItem {
  std::vector<double> pts;  // flattened polyline x,y pairs
};

struct ImagePlacement {
  double x0, y0, x1, y1;  // placed quad bbox in device space
  int obj_num = -1;       // XObject number (-1 = inline image)
  int width = 0, height = 0, bpc = 8;
  std::string colorspace;
  std::string filter;  // passthrough filter (DCTDecode etc.) or "" for raw
  std::string name;    // resource name
};

struct PageContent {
  std::vector<TextRun> texts;
  std::vector<SegItem> segs;
  std::vector<RectItem> rects;
  std::vector<CurveItem> curves;
  std::vector<ImagePlacement> images;
};

// Run the interpreter over a page's (concatenated) content streams.
PageContent extract_page_content(Document* doc, const Page& page);

}  // namespace pdfio
